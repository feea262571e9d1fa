"""Parallelism over several cards.  So far only ``tp.resolve_tp``, which
keeps TRAIN.TENSOR_PARALLEL from being ignored quietly on one card."""
