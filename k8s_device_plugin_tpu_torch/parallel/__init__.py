"""Data parallelism and FSDP over ``torch.distributed`` (the reference's
``parallel/mesh.py``, ``sharding.py`` and ``distributed.py``)."""
