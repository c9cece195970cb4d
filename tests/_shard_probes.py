"""Rank functions for the launcher's own failure paths
(tests/test_torch_sharding.py): they import torch only, so a spawned rank
starts in seconds."""
import time

import torch.distributed as dist


def fail_on_rank_1(group):
    """Rank 1 raises at once; the others wait in a collective that rank 1
    never joins (the launcher must stop them, not the gloo timeout)."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def sleep(group, seconds):
    time.sleep(seconds)
    return group.rank


def default_group_device(group):
    """`current_group` over a default group that `init_shards` did not set
    up (as under torchrun): (the error of device None, or None when it
    resolved; its device; the device of an explicit "cpu")."""
    from repro_torch.launch import mesh
    mesh._CURRENT = None
    try:
        raised, dev = None, str(mesh.current_group().device.type)
    except RuntimeError as e:
        raised, dev = str(e), None
    return raised, dev, str(mesh.current_group("cpu").device)
