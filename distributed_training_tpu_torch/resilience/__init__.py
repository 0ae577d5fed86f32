"""Resilience of the port's training runs (the port of
``distributed_training_tpu/resilience``):

- :mod:`async_ckpt`: the background checkpoint writer;
- :mod:`retry`: the deterministic transient-I/O retry of the loaders;
- :mod:`verify`: checksum manifests, the COMMITTED marker, quarantine;
- :mod:`errors`: the typed failure-path errors;
- :mod:`chaos`: seeded, step-addressed fault injection.
"""
