"""Hand-written Hopper kernels and their plain PyTorch versions: the
pruned-FedSGD round's (pruning_mask.py) and the LM stack's
(flash_attention.py, decode_attention.py, ssd_chunk.py), the entry points
that call them (ops.py) and their launch counters (counters.py). The CUDA
library is built at first CUDA use (_build.py), never at import."""
