"""The port's counterparts of the JAX package's kernel tools in ``tools/``:
``flash_kernel_bench`` and ``conv_fusion_probe``, each run as
``python -m distributed_training_tpu_torch.tools.<name>``."""
