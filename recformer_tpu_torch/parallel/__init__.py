"""Data and tensor parallelism over ``torch.distributed``.

Counterpart of ``recformer_tpu/parallel/``'s ``mesh``, ``catalog`` and
``tensor`` modules: one process per rank (started by ``python -m
torch.distributed.run``), a ``data`` x ``model`` layout of process groups
(``mesh.py``), the differentiable collectives JAX takes from ``lax``
(``collectives.py``), the row-sharded item catalog (``catalog.py``),
Megatron-style tensor parallelism (``tensor.py``) and the multi-rank dry run
(``dryrun.py``). Sequence and pipeline parallelism are not ported yet.
"""
