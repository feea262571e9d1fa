"""The benchmark of the PyTorch and CUDA port, ``rpo_tpu_torch``, on the card.

``python3 -m benchmark.run`` runs one cell of ``BENCHMARK.json``; see
``README.md``.  Nothing here imports JAX or the JAX package.
"""
