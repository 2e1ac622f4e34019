"""Device operations. `spmv_bsr` holds the BSR SpMV kernels' wrappers and
their plain PyTorch versions; `_cuda` builds and loads the CUDA library.
(The functions are not re-exported here: `spmv_bsr` names both the module
and its main function.)"""
