"""Multi-device execution of the 2-D plasma over torch.distributed
(counterpart of lbm_tpu/parallel): the (dy, dx) device mesh and ring
exchanges (mesh), block placement (sharding), the sharded Poisson solve
(poisson) and the halo-exchange steps with their CUDA kernels
(fused_sharded)."""
