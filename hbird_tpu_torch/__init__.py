"""hbird_tpu_torch — the Hummingbird dense-NN-retrieval evaluation in PyTorch.

The PyTorch/CUDA port of `hbird_tpu`, for one NVIDIA Hopper GPU. It keeps
the JAX package's module names so each counterpart is easy to find:

- frozen ViT patch features from a PyTorch backbone (`models/`): the
  package's ViT, its attention plain or through a hand-written flash
  attention kernel (`attention_impl='flash'`, `ops/csrc/flash_attn.cu`),
  with weights converted from timm or HuggingFace checkpoints
  (`models/convert.py`), or any live torch module
  (`models/torch_adapter.py`),
- a device-resident memory bank of L2-normalized patch embeddings and
  per-patch soft labels,
- exact k-nearest-neighbour retrieval through a hand-written CUDA kernel
  (`ops/csrc/knn_topk.cu`: fused q·bᵀ + streaming top-k, the Q×M score
  matrix never materialised), or approximate retrieval over an IVF tree
  (`nn_method='ivf'`: k-means leaves, probed-leaf scan in
  `ops/csrc/ivf_topk.cu`),
- soft-label cross-attention transfer and confusion-matrix mIoU,
- the bank and the built tree saved and reloaded in the JAX package's
  formats (`bank/io.py`; a tree can also be built from a saved bank by the
  streamed build, which never holds the flat bank on the card),
- the command line, `python -m hbird_tpu_torch.eval_cli`, with the flags
  of the JAX package's `eval.py`.

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
GPU and no explicit CPU request they raise.
"""

from hbird_tpu_torch.version import __version__

__all__ = ["HbirdEvaluation", "hbird_evaluation", "__version__"]


def __getattr__(name):  # PEP 562 lazy import: keeps `import hbird_tpu_torch` light
    if name in ("HbirdEvaluation", "hbird_evaluation"):
        from hbird_tpu_torch import hbird_eval

        return getattr(hbird_eval, name)
    raise AttributeError(f"module 'hbird_tpu_torch' has no attribute {name!r}")
