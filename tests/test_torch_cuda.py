"""The port's kernels on the card against their plain versions.

These need an NVIDIA card (marker ``cuda``) and skip elsewhere. They import
no JAX, so on a machine with a card and no JAX they run with

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core import sumtree
from repro_torch.kernels import nstep_return, replay_ingest, sumtree_sample, sumtree_update

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _tree(cap, gen):
    leaves = torch.rand((cap,), generator=gen, device="cuda") + 1e-3
    leaves[torch.rand((cap,), generator=gen, device="cuda") < 0.2] = 0
    return sumtree.rebuild(leaves)


@pytest.mark.parametrize("cap,B", [(2, 5), (64, 300), (1 << 12, 1000)])
def test_sumtree_update_kernel_is_bitwise_the_plain_version(gen, cap, B):
    tree = _tree(cap, gen)
    idx = torch.randint(-cap - 2, 2 * cap + 2, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx[B // 2:] = idx[: B - B // 2].clone()                   # duplicate writers
    values = torch.rand((B,), generator=gen, device="cuda")
    before = sumtree_update.ops.launches
    got = sumtree_update.ops.sumtree_update(tree.clone(), idx, values)
    assert sumtree_update.ops.launches == before + 1
    want = sumtree_update.ref.sumtree_update_ref(tree.clone(), idx, values)
    assert torch.equal(got, want)


def test_sumtree_sample_kernel_is_exact(gen):
    tree = _tree(256, gen)
    prefix = torch.cumsum(sumtree.leaves(tree), 0)
    u = torch.cat([prefix, torch.rand((77,), generator=gen, device="cuda") * tree[1]])
    idx, mass = sumtree_sample.ops.sumtree_sample_with_mass(tree, u)
    want_idx, want_mass = sumtree_sample.ref.sumtree_sample_with_mass_ref(tree, u)
    assert torch.equal(idx, want_idx) and torch.equal(mass, want_mass)


def test_replay_ingest_kernel_matches_the_plain_version(gen):
    cap, B = 64, 200
    tree = _tree(cap, gen)

    def store(n):
        return {"obs": torch.randint(0, 256, (n, 7), generator=gen, device="cuda",
                                     dtype=torch.uint8),
                "action": torch.randint(0, 4, (n,), generator=gen, device="cuda",
                                        dtype=torch.int32),
                "returns": torch.randn((n,), generator=gen, device="cuda")}

    storage, items = store(cap), store(B)
    idx = torch.randint(-cap - 2, 2 * cap, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    applied = torch.rand((B,), generator=gen, device="cuda") < 0.6
    prio = torch.randn((B,), generator=gen, device="cuda")
    got_t, got = replay_ingest.ops.replay_ingest(
        tree.clone(), {k: v.clone() for k, v in storage.items()}, idx, prio, applied, items)
    want_t, want = replay_ingest.ref.replay_ingest_ref(
        tree.clone(), {k: v.clone() for k, v in storage.items()}, idx, prio, applied, items)
    for k in storage:
        assert torch.equal(got[k], want[k]), k
    assert torch.allclose(got_t, want_t, rtol=1e-6, atol=0)
    assert torch.equal(got_t, sumtree.rebuild(sumtree.leaves(got_t)))


@pytest.mark.parametrize("lanes,T,n", [(5, 3, 3), (360, 64, 3), (9, 130, 4)])
def test_nstep_return_kernel_within_1e6(gen, lanes, T, n):
    reward = torch.rand((lanes, T), generator=gen, device="cuda")
    discount = torch.where(torch.rand((lanes, T), generator=gen, device="cuda") < 0.1,
                           0.0, 0.99)
    got = nstep_return.ops.nstep_return(reward, discount, n)
    want = nstep_return.ref.nstep_return_ref(reward, discount, n)
    for g, w in zip(got, want):
        assert g.shape == w.shape and float((g - w).abs().max()) <= 1e-6


def test_wrappers_check_their_inputs(gen):
    tree = _tree(64, gen)
    with pytest.raises(ValueError):
        sumtree_update.ops.sumtree_update(torch.zeros(256, device="cuda")[::2],
                                          torch.zeros(1, dtype=torch.int32, device="cuda"),
                                          torch.zeros(1, device="cuda"))
    with pytest.raises(ValueError):
        sumtree_sample.ops.sumtree_sample_with_mass(tree.double(), torch.zeros(2, device="cuda"))
    with pytest.raises(ValueError):
        nstep_return.ops.nstep_return(torch.zeros((4, 8), device="cuda")[:, ::2],
                                      torch.zeros((4, 4), device="cuda"), 3)
