"""Parallelism over several cards, one process a card: data parallelism
(``dp.py``: the mesh, the loader's padding, the per-rank train algebra
and the gathered eval) and tensor parallelism (``tp.py``: the dp x tp
grid, the sliced blocks and their sums), the JAX package's
``parallel/`` over ``torch.distributed``."""
