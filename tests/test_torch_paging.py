"""The port's paging module (tpuserver_torch.paging) held against the JAX
package's (tpuserver.paging): the same allocator and radix-tree
operations, applied to both, give equal results.  Pure host code, no
tensors."""

import numpy as np
import pytest

from tpuserver import paging as jax_paging
from tpuserver_torch import paging as port_paging

pytestmark = pytest.mark.torch_port


def _nodes(nodes):
    return [(n.page, n.ref, n.key) for n in nodes]


def _state(radix):
    return (radix.pages, radix.unreferenced, radix.version,
            sorted(map(tuple, radix.iter_sequences())))


def _allocator(mod):
    alloc = mod.PageAllocator(6, 4)
    out = [mod.pages_for(n, 4) for n in (0, 1, 4, 5, 16, 17)]
    got = alloc.alloc(4)
    out += [got, alloc.free_count, alloc.alloc(3), alloc.free_count]
    alloc.free(got[1:3])
    out += [alloc.alloc(4), alloc.free_count]
    with pytest.raises(ValueError):
        mod.PageAllocator(0, 4)
    with pytest.raises(ValueError):
        mod.PageAllocator(4, 0)
    return out


def _match_pin_evict(mod):
    radix = mod.RadixPrefixCache(4)
    toks = list(range(12))
    out = [radix.match(toks)]
    created, dups, freed = radix.insert_tail([], toks, 0, [10, 11, 12],
                                             pin=False)
    out += [_nodes(created), dups, freed, _state(radix)]
    path, ids = radix.match(toks)
    out += [ids, radix.match(toks[:8] + [99, 98, 97, 96])[1]]
    radix.acquire(path)
    out += [_nodes(path), radix.evict(3), _state(radix)]
    radix.release(path)
    out += [radix.evict(1), radix.evict(5), _state(radix)]
    return out


def _duplicates_and_continuation(mod):
    radix = mod.RadixPrefixCache(4)
    toks = list(range(8)) + [50, 51, 52, 53]
    radix.insert_tail([], toks, 0, [1, 2, 3], pin=False)
    created, dups, freed = radix.insert_tail([], toks[:8], 0, [7, 8],
                                             pin=True)
    out = [_nodes(created), dups, freed, _state(radix)]
    out += [radix.continuation(toks[:5], 6), radix.continuation([9], 3)]
    radix.release(created)
    with pytest.raises(ValueError, match="past the known token prefix"):
        radix.insert_tail([], toks[:6], 0, [4, 5], pin=False)
    out += [_state(radix)]
    return out


def _lru_leaf_first(mod):
    radix = mod.RadixPrefixCache(2)
    a, _, _ = radix.insert_tail([], [1, 2], 0, [0], pin=False)
    radix.insert_tail([], [3, 4], 0, [1], pin=False)
    radix.acquire(a)
    radix.release(a)
    return [radix.evict(1), _state(radix)]


def _random_ops(mod, seed):
    """A seeded mix of match / acquire / insert / release / evict /
    alloc / free, as the scheduler drives them."""
    rng = np.random.RandomState(seed)
    page = 2
    alloc = mod.PageAllocator(24, page)
    radix = mod.RadixPrefixCache(page)
    held = []  # pinned node paths
    out = []
    for _ in range(60):
        op = rng.randint(4)
        if op == 0 or not held:
            toks = list(rng.randint(0, 3, size=rng.randint(2, 9)))
            path, ids = radix.match(toks)
            radix.acquire(path)
            want = len(toks) // page - len(path)
            owned = alloc.alloc(want)
            if owned is None:
                freed = radix.evict(want - alloc.free_count)
                alloc.free(freed)
                out.append(("evicted", freed))
                owned = alloc.alloc(want) or []
            new, dups, dup_ids = radix.insert_tail(
                path, toks, len(path), owned, pin=True)
            alloc.free(dup_ids)
            out.append(("admit", ids, _nodes(new), dups, dup_ids))
            held.append(path + new)
        elif op == 1:
            radix.release(held.pop(rng.randint(len(held))))
        elif op == 2:
            out.append(("evict", radix.evict(rng.randint(1, 4))))
        else:
            out.append(("free", alloc.free_count))
        out.append(_state(radix))
    return out


@pytest.mark.parametrize("scenario", [
    _allocator, _match_pin_evict, _duplicates_and_continuation,
    _lru_leaf_first], ids=lambda f: f.__name__.strip("_"))
def test_paging_matches_jax_package(scenario):
    assert scenario(port_paging) == scenario(jax_paging)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_paging_ops_match_jax_package(seed):
    assert _random_ops(port_paging, seed) == _random_ops(jax_paging, seed)
