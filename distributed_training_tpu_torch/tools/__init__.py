"""The port's counterparts of the repo's ``tools/``: the kernel tools
``flash_kernel_bench`` and ``conv_fusion_probe``, ``flight_report`` and
``trace_report``, each run as ``python -m
distributed_training_tpu_torch.tools.<name>``."""
