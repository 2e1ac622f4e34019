"""Device operations. `spmv_bsr` holds the BSR SpMV kernels' wrappers and
their plain PyTorch versions, `interp_well` the window-ELL kernel's, `spmv`
the ELL gather SpMV (plain torch ops); `_cuda` builds and loads the CUDA
libraries. (The functions are not re-exported here: `spmv_bsr` names both
the module and its main function.)"""
