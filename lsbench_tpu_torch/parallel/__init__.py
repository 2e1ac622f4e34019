"""Distributed solvers over a block-row partition on `torch.distributed`
(counterpart of `lsbench_tpu/parallel/`): the row "mesh" as a process
group (`mesh.py`), the host ordering (`perm.py`), the halo-exchange SpMV
(`dist_spmv.py`), the 1-D Krylov family built on it (`dist_cg.py`,
`dist_cg_ir.py`, `dist_bicgstab.py`, `dist_gmres.py`, `dist_block_cg.py`),
the row-partitioned AMG cycle (`dist_amg.py`), and the 2-D grid's SpMV and
solvers (`dist2d.py`, the 2-D IR classes of `dist_cg_ir.py`,
`dist_amg2d.py`), the static accounting of their collectives and a
strong-scaling model (`comm_model.py`), and a dry run of every solver
(`dryrun.py`). `launch.py` starts the ranks of a run, one process each;
ranks of processes started apart meet at a coordinator
(`mesh.init_distributed`)."""
