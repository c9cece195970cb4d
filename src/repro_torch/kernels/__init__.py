"""Hand-written Hopper kernels of the pruned-FedSGD round and their plain
PyTorch versions (pruning_mask.py), and the packed entry points the round
engine calls (ops.py). The CUDA library is built at first CUDA use
(_build.py), never at import."""
