"""Device operations of racon_tpu_torch: the CUDA kernels' wrappers, their
plain PyTorch versions, and the phase drivers around them."""
