"""Multi-process extraction over ``torch.distributed`` (counterpart of
``coma_tpu.parallel``'s multihost path)."""
