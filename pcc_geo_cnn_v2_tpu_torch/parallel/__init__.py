"""Parallel execution: data-parallel training over a ``torch.distributed``
process group (:mod:`.mesh`). The chunk round-robin of inference is
``codec.BlockCodec(devices=...)``."""
