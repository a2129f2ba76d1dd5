"""Hand-written CUDA kernels for Hopper (`sm_90a`) and their wrappers.

Each wrapper calls a custom op (`torch.ops.offsetguided.peaks_topk`,
`.topk`, `.nms_topk`, `.group_skeletons`) whose CUDA implementation
launches its kernel and counts the launch in the wrapper's `launches`
attribute, and whose CPU implementation is the plain PyTorch version. A
build or launch failure raises. Importing this package registers the four
ops, which loading a `torch.export` program that calls them needs."""
from . import grouping, nms_topk, peaks, topk  # noqa: F401  (registers the ops)
