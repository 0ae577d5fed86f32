"""Parallel strategies of the port: ZeRO data parallelism, ring attention
(sequence parallelism), megatron tensor parallelism and its ring-overlapped
collective matmuls."""
