"""Data, tensor, pipeline and sequence parallelism over ``torch.distributed``.

Counterpart of ``recformer_tpu/parallel/``: one process per rank (started by
``python -m torch.distributed.run``), a ``data`` x ``model`` (or ``pipe``, or
``seq``) layout of process groups (``mesh.py``), the differentiable
collectives JAX takes from ``lax``, ``ppermute`` among them
(``collectives.py``), the row-sharded item catalog (``catalog.py``),
Megatron-style tensor parallelism (``tensor.py``), GPipe pipeline
parallelism (``pipeline.py``), sequence (context) parallelism
(``sequence.py``) and the multi-rank dry run (``dryrun.py``).
"""
