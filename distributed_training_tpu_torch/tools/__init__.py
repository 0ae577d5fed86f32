"""The port's counterparts of the repo's ``tools/``: the kernel tools
``flash_kernel_bench`` and ``conv_fusion_probe``; the report tools
``flight_report``, ``trace_report``, ``incident_report`` and
``fleet_trace``; the serving tools ``serve_bench``, ``serve_net`` and
``traffic``; ``profile_step``; and ``collective_accounting``. Each runs
as ``python -m
distributed_training_tpu_torch.tools.<name>``."""
