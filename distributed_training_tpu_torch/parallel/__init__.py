"""Parallel strategies of the port: ZeRO data parallelism and the
unsharded attention."""
