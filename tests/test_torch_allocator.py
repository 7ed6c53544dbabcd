"""The port's block allocator (its own copy of block_allocator.cc, built into
build/runtime/) against the JAX package's, call for call."""

import pytest

from hpc_ops_tpu.runtime import PagedBlockAllocator as JaxAllocator
from hpc_ops_tpu_torch.runtime import PagedBlockAllocator

SCENARIOS = {
    "extend": (16, 4, [("extend", 1, 5), ("extend", 1, 8), ("extend", 1, 9),
                       ("length", 1), ("table", 1, 6), ("free", 1), ("num_free",)]),
    "exhaust": (2, 4, [("extend", 1, 8), ("extend", 2, 1), ("table", 2, None),
                       ("free", 1), ("extend", 2, 1), ("num_free",)]),
    "fork_cow": (8, 4, [("extend", 10, 8), ("fork", 10, 11), ("cow_last", 11),
                        ("cow_last", 10), ("table", 11, None), ("free", 10),
                        ("num_free",), ("free", 11), ("num_free",)]),
    "share_prefix": (8, 4, [("extend", 1, 9), ("share_prefix", 1, 2, 2),
                            ("extend", 2, 12), ("table", 2, 5), ("free", 1),
                            ("num_free",), ("share_prefix", 7, 8, 1)]),
}


def run(alloc_cls, num_blocks, block_size, ops):
    a = alloc_cls(num_blocks, block_size)
    out = []
    for name, *args in ops:
        try:
            if name == "num_free":
                out.append(a.num_free)
            elif name == "table":
                out.append(a.table(args[0], pad_to=args[1]).tolist())
            else:
                out.append(getattr(a, name)(*args))
        except (MemoryError, KeyError) as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_allocator_matches_jax(scenario):
    want = run(JaxAllocator, *SCENARIOS[scenario])
    got = run(PagedBlockAllocator, *SCENARIOS[scenario])
    assert got == want
    assert any(isinstance(x, list) and -1 in x for x in got) or scenario != "extend"
