"""recformer_tpu_torch: the PyTorch + CUDA port of the JAX package ``recformer_tpu``.

It keeps the JAX package's module layout and names. The serving path runs
here: item encoding, full-catalog ranked evaluation and top-k serving with
the Recformer backbone, whose windowed + global attention is a hand-written
CUDA kernel for Hopper (``ops/window_attention.py``). Nothing here imports
JAX or the JAX package.
"""

from .config import RecformerConfig
from .data.tokenization import RecformerTokenizer
from .models.heads import RecformerForSeqRec, cosine_similarity, similarity_scores
from .models.recformer import RecformerModel

__version__ = "0.1.0"

__all__ = [
    "RecformerConfig",
    "RecformerModel",
    "RecformerForSeqRec",
    "RecformerTokenizer",
    "cosine_similarity",
    "similarity_scores",
]
