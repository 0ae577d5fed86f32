"""Process groups and coordination of the port (``torch.distributed``)."""
