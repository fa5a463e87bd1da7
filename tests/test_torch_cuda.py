"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips itself without a GPU;
this file imports no JAX, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: 1e-5 for a rotation (fp32 adds of
unit-scale values, same order as the plain butterfly), 2e-6 for the
masked mean (at most 4 products summed). The quantized-exchange kernels B3,
B4 and B6, and THC's quantizer B7, must equal their plain versions bitwise (the same butterfly, max
exact in any order, the quantizer's IEEE ops in the same order); B5 sums at
most 4 dequantized values of magnitude <= amax, in peer order where the
plain version's reduction may pick another order: within 8 ulp of amax.
Non-finite input keeps the plain versions' semantics exactly: B3 passes
NaN through as ``torch.amax`` does, and a NaN quotient gives code 0.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.allreduce import OptiReduceConfig, sync_packed
from repro_torch.core.compression import thc_compress
from repro_torch.core.pipeline import GeneratorDraws, SyncContext
from repro_torch.kernels.dequant_reduce import dequant_masked_mean
from repro_torch.kernels.dequant_reduce import ops as dq_ops
from repro_torch.kernels.fwht import ops as fwht_ops
from repro_torch.kernels.fwht import randomized_fwht
from repro_torch.kernels.fwht import ref as fwht_ref
from repro_torch.kernels.masked_sum import masked_mean
from repro_torch.kernels.masked_sum import ops as mm_ops
from repro_torch.kernels.ht_quant import ht_amax, ht_quant
from repro_torch.kernels.ht_quant import ops as hq_ops
from repro_torch.kernels.ht_quant import ref as hq_ref
from repro_torch.kernels.masked_sum.ref import masked_mean_ref
from repro_torch.kernels.quant import grid_quant, uniform_quant
from repro_torch.kernels.quant import ops as gq_ops
from repro_torch.kernels.quant.ref import grid_quant_ref, uniform_quant_ref
from repro_torch.sim.tta import KeyDraws, TrainRunConfig, _aggregate

ROT_TOL = 1e-5
MEAN_TOL = 2e-6

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("n", [16, 32, 128, 1024, 2048, 4096])
@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_fwht_kernel_matches_plain(dev, n, mode):
    g = _gen(dev, n)
    x = torch.randn((37, n), generator=g, device=dev)       # ragged rows
    sign = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, 1., -1.)
    before = fwht_ops.launches
    got = randomized_fwht(x, sign, mode=mode)
    assert fwht_ops.launches == before + 1
    torch.testing.assert_close(
        got, fwht_ref.randomized_fwht_ref(x, sign, mode=mode),
        atol=ROT_TOL, rtol=0)


def test_fwht_kernel_reads_peer_views(dev):
    """Strided arena slices and broadcast all_gather views, as the sync
    engine hands them over."""
    g = _gen(dev, 1)
    arena = torch.randn((4, 3, 4096), generator=g, device=dev)
    view = arena[:, 1].view(4, -1, 1024)
    torch.testing.assert_close(fwht_ops.fwht_launch(view, None, "none"),
                               fwht_ref.fwht_ref(view), atol=ROT_TOL, rtol=0)
    own = torch.randn((4, 2048), generator=g, device=dev)
    bcast = own.reshape(1, -1).expand(4, -1).view(4, -1, 1024)
    torch.testing.assert_close(fwht_ops.fwht_launch(bcast, None, "none"),
                               fwht_ref.fwht_ref(bcast), atol=ROT_TOL,
                               rtol=0)


def test_fwht_kernel_rejects_lengths_it_does_not_take(dev):
    with pytest.raises(ValueError):
        fwht_ops.fwht_launch(torch.zeros((2, 8192), device=dev), None,
                             "none")


@pytest.mark.parametrize("length", [4096, 1001])
def test_masked_mean_kernel_matches_plain(dev, length):
    g = _gen(dev, length)
    data = torch.randn((4, 4 * length), generator=g, device=dev)
    received = data.view(4, 4, length).transpose(0, 1)       # a2a view
    mask = (torch.rand((4, 4, length), generator=g, device=dev)
            < 0.8).float()
    mask[:, :, :9] = 0.0
    before = mm_ops.launches
    got = masked_mean(received, mask)
    assert mm_ops.launches == before + 1
    torch.testing.assert_close(got, masked_mean_ref(received, mask),
                               atol=MEAN_TOL, rtol=0)
    assert bool((got[:, :9] == 0).all())


def _grids(amax, bits=8):
    amax = torch.clamp(amax, min=1e-12)
    return -amax, 2.0 * amax / ((1 << bits) - 1)


HT_SIZES = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096]


def _peer_views(g, dev, peers, rows, n):
    """A strided (P, rows, n) arena slice, as the sync engine hands it over,
    and a stride-0 broadcast view of one peer's rows."""
    arena = torch.randn((peers, 2, rows * n), generator=g, device=dev)
    own = torch.randn((rows, n), generator=g, device=dev)
    return {"strided": arena[:, 1].view(peers, rows, n),
            "broadcast": own.unsqueeze(0).expand(peers, rows, n)}


@pytest.mark.parametrize("n", HT_SIZES)
def test_ht_amax_kernel_equals_plain(dev, n):
    """Every block length (odd log2 n keeps the division by sqrt(n)), 1, 3
    and 4 peers, rows that are not a multiple of a tile (ragged last tile),
    strided and broadcast peer views."""
    g = _gen(dev, n)
    sign = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, 1., -1.)
    for peers in (1, 3, 4):
        for kind, x in _peer_views(g, dev, peers, 37, n).items():
            before = hq_ops.amax_launches
            got = ht_amax(x, sign)
            assert hq_ops.amax_launches == before + 1
            assert got.shape == (peers, 37)
            assert torch.equal(got, hq_ref.ht_amax_ref(x, sign)), (peers,
                                                                   kind)


@pytest.mark.parametrize("bits", [8, 4, 1])
@pytest.mark.parametrize("n", HT_SIZES)
def test_ht_quant_kernel_equals_plain(dev, n, bits):
    """Per-peer rows of a strided arena slice (and a broadcast view), one
    shared copy of the noise and grids: 1, 3 and 4 peers, 12 rows a peer
    and G = 4, 6 or 12 grid rows (row i reads grid i % G), and 13 rows a
    peer with G = 13 (a ragged last tile)."""
    g = _gen(dev, 100 + n + bits)
    sign = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, 1., -1.)
    for peers in (1, 3, 4):
        for rows, grids in ((12, (4, 6, 12)), (13, (13,))):
            for kind, x in _peer_views(g, dev, peers, rows, n).items():
                amax = hq_ref.ht_amax_ref(x, sign).amax(0)
                for gr in grids:
                    noise = torch.rand((gr, n), generator=g, device=dev)
                    lo, step = _grids(amax.view(-1, gr).amax(0), bits)
                    before = hq_ops.quant_launches
                    got = ht_quant(x, sign, noise, lo, step, bits=bits)
                    assert hq_ops.quant_launches == before + 1
                    assert got.dtype == torch.uint8 and got.shape == x.shape
                    assert torch.equal(got, hq_ref.ht_quant_ref(
                        x, sign, noise, lo, step, bits=bits)), (peers, rows,
                                                               kind, gr)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("s,block", [(4096, 1024), (1000 * 16, 16)])
def test_dequant_mean_kernel_matches_plain(dev, s, block, masked):
    """On the all_to_all view of the codes, each receiver on its own grid
    slice."""
    g = _gen(dev, s + masked)
    p = 4
    sent = torch.randint(0, 256, (p, p * s), generator=g, device=dev,
                         dtype=torch.uint8)
    received = sent.view(p, p, s).transpose(0, 1)
    amax = torch.rand(p * s // block, generator=g, device=dev) * 3 + 0.1
    lo, step = _grids(amax)
    lo, step = lo.view(p, -1), step.view(p, -1)
    mask = None
    if masked:
        mask = (torch.rand((p, p, s), generator=g, device=dev) < 0.8).float()
        mask[:, :, :9] = 0.0
    before = dq_ops.launches
    got = dequant_masked_mean(received, lo, step, mask, block=block)
    assert dq_ops.launches == before + 1
    want = dequant_masked_mean(received.cpu(), lo.cpu(), step.cpu(),
                               None if mask is None else mask.cpu(),
                               block=block)
    tol = 8 * 2.0 ** -23 * float(amax.max())
    torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=0)
    if masked:
        assert bool((got[:, :9] == 0).all())


@pytest.mark.parametrize("cols", [1024, 1000])
def test_grid_quant_kernel_equals_plain(dev, cols):
    g = _gen(dev, cols)
    p, r = 4, 25
    x = torch.randn((p * r, cols), generator=g, device=dev)
    noise = torch.rand((r, cols), generator=g, device=dev)
    lo, step = _grids(x.abs().amax(-1))
    before = gq_ops.launches
    got = grid_quant(x, noise, lo, step, bits=8)
    assert gq_ops.launches == before + 1
    assert torch.equal(got, grid_quant_ref(x, noise, lo, step, bits=8))


def test_quant_kernels_reject_widths_they_do_not_take(dev):
    """B5 and B6 take 4 columns a thread; the sync engine's Hadamard
    blocks (16..4096) always allow it."""
    x = torch.zeros((8, 1001), device=dev)
    g = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        gq_ops.grid_quant_launch(x, x, g, g, bits=8)
    codes = torch.zeros((1, 4, 36), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="multiple"):
        dq_ops.dequant_mean_launch(codes, g[None, :4], g[None, :4], None,
                                   block=9)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("cols", [1024, 4096])
def test_uniform_quant_kernel_equals_plain(dev, cols, bits):
    """B7 on a (W, R, C) stack with one shared (R, C) noise copy and the
    range as the harness forms it; a NaN gives code 0 as in the plain
    version."""
    g = _gen(dev, cols + bits)
    w, r = 8, 37
    x = torch.randn((w, r, cols), generator=g, device=dev)
    x[3, 5, 7] = float("nan")
    noise = torch.rand((r, cols), generator=g, device=dev)
    finite = x.nan_to_num()
    lohi = torch.stack([finite.min() * 1.2 - 1e-3, finite.max() * 1.2 + 1e-3])
    before = gq_ops.uniform_launches
    got = uniform_quant(x, noise, lohi, bits=bits)
    assert gq_ops.uniform_launches == before + 1
    want = uniform_quant_ref(x.reshape(-1, cols), noise, lohi[0], lohi[1],
                             bits=bits).view(x.shape)
    assert torch.equal(got, want)
    assert int(got[3, 5, 7]) == 0


def test_uniform_quant_kernel_rejects_what_it_does_not_take(dev):
    """B7 takes 4 columns a thread and its range as 2 fp32 on the card."""
    lohi = torch.tensor([-1.0, 1.0], device=dev)
    x = torch.zeros((8, 1001), device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        gq_ops.uniform_quant_launch(x, x, lohi, bits=4)
    x = torch.zeros((8, 1024), device=dev)
    with pytest.raises(ValueError, match="lohi"):
        gq_ops.uniform_quant_launch(x, x, lohi.cpu(), bits=4)
    with pytest.raises(ValueError, match="lohi"):
        gq_ops.uniform_quant_launch(x, x, torch.zeros(3, device=dev), bits=4)
    with pytest.raises(TypeError):
        gq_ops.uniform_quant_launch(x, x, lohi.double(), bits=4)
    with pytest.raises(ValueError, match="must divide"):
        gq_ops.uniform_quant_launch(x, x[:3], lohi, bits=4)


def test_thc_aggregate_on_card_matches_cpu(dev):
    """THC's aggregation, one B1 encode, one B7 and one B1 decode on the
    card, against the plain versions on the CPU with the same draws: codes
    equal but for isolated floor-boundary flips (the two rotations sum in
    another order), each moving its block by one grid step /
    (N sqrt(block))."""
    n, block = 4, 1024
    rc = TrainRunConfig(n_workers=n, hadamard_block=block, compressor="thc")
    x = torch.randn((n, 30_000), generator=torch.Generator().manual_seed(1))
    cpu = torch.device("cpu")

    class HostDraws:
        inner = KeyDraws(cpu)

        def sign(self, k, b):
            return self.inner.sign(k, b).to(dev)

        def uniform(self, k, shape):
            return self.inner.uniform(k, shape).to(dev)

    want, _ = _aggregate(x, (0, 3), rc, {}, draws=HostDraws.inner)
    b1, b7 = fwht_ops.launches, gq_ops.uniform_launches
    got, _ = _aggregate(x.to(dev), (0, 3), rc, {}, draws=HostDraws())
    assert (fwht_ops.launches - b1, gq_ops.uniform_launches - b7) == (2, 1)
    # the codes the two aggregations summed, from the same draws
    g = F.pad(x, (0, (-x.shape[1]) % (n * block)))
    lohi = torch.stack([g.min() * 1.2 - 1e-3, g.max() * 1.2 + 1e-3])
    sign = HostDraws.inner.sign((0, 3), block)
    noise = HostDraws.inner.uniform((0, 3, 1), (g.shape[1] // block, block))
    sums = [thc_compress(g.to(d), sign.to(d), noise.to(d), lohi.to(d),
                         block=block).codes.to(torch.int32).sum(0).cpu()
            for d in (cpu, dev)]
    flips = (sums[1] - sums[0]).abs()
    assert int(flips.sum()) <= 1e-4 * flips.numel() * n
    lo, hi = lohi.tolist()
    step = (hi - lo) / 15
    bound = (flips.sum(1).float() * step / (n * block ** 0.5)) \
        .repeat_interleave(block)[:30_000]
    assert bool(((got.cpu() - want).abs() <= bound + ROT_TOL).all())


@pytest.mark.parametrize("n", [16, 32, 1024, 2048, 4096])
def test_ht_kernels_pass_non_finite_values_as_plain(dev, n):
    """A NaN or an inf spreads over its block in the rotation: B3's amax
    of that block is NaN (inf) as in the plain version, and B4's codes on
    such grids equal the plain version's (a NaN quotient gives code 0)."""
    g = _gen(dev, 200 + n)
    x = torch.randn((4, 9, n), generator=g, device=dev)
    x[1, 2, 3] = float("nan")
    x[3, 7, 0] = float("inf")
    sign = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, 1., -1.)
    got = ht_amax(x, sign)
    want = hq_ref.ht_amax_ref(x, sign)
    torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)
    assert bool(got[1, 2].isnan()) and bool(got[3, 7].isinf())
    noise = torch.rand((9, n), generator=g, device=dev)
    for bits in (8, 4, 1):
        lo, step = _grids(got.amax(0), bits)
        assert bool(lo[2].isnan()) and bool(step[7].isinf())
        assert torch.equal(ht_quant(x, sign, noise, lo, step, bits=bits),
                           hq_ref.ht_quant_ref(x, sign, noise, lo, step,
                                               bits=bits)), bits


@pytest.mark.parametrize("strategy", ["optireduce", "optireduce_q"])
@pytest.mark.parametrize("mode", ["scan", "pipelined"])
def test_sync_packed_on_card_matches_cpu(dev, mode, strategy):
    """The whole sync path, card kernels against CPU plain versions, with
    the same draws."""
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=0.05,
                           drop_pattern="bernoulli", hadamard_block=1024)
    cpu = torch.device("cpu")
    arena = torch.randn((4, 3, 16_384), generator=torch.Generator()
                        .manual_seed(0))

    class HostDraws:
        inner = GeneratorDraws((0,), cfg, cpu)

        def sign(self, b, block):
            return self.inner.sign(b, block).to(dev)

        def mask(self, b, r, n, s):
            return self.inner.mask(b, r, n, s).to(dev)

        def noise(self, b, salt, shape):
            return self.inner.noise(b, salt, shape).to(dev)

    want = sync_packed(arena, SyncContext(cfg=cfg, draws=HostDraws.inner),
                       mode=mode)
    got = sync_packed(arena.to(dev), SyncContext(cfg=cfg, draws=HostDraws()),
                      mode=mode)
    torch.testing.assert_close(got.cpu(), want, atol=ROT_TOL, rtol=0)


class _HostDraws:
    """The CPU provider's draws, served on the card: both runs of a
    comparison see the same signs, masks and noises."""

    def __init__(self, cfg, dev):
        self.inner = GeneratorDraws((0,), cfg, torch.device("cpu"))
        self.dev = dev

    def sign(self, b, block):
        return self.inner.sign(b, block).to(self.dev)

    def mask(self, b, r, n, s, self_index=None):
        return self.inner.mask(b, r, n, s, self_index=self_index).to(self.dev)

    def noise(self, b, salt, shape):
        return self.inner.noise(b, salt, shape).to(self.dev)


@pytest.mark.parametrize("strategy,rate,policy", [
    ("optireduce_rounds", 0.05, {}), ("tar_rounds_q", 0.05, {}),
    ("tar_rounds", 0.0, {}), ("gloo_ring", 0.0, {}), ("nccl_tree", 0.0, {}),
    ("bcube", 0.0, {}), ("ring_ht", 0.0, {}),
    ("optireduce", 0.05, {"active_peers": (0, 1, 3)}),
    ("optireduce_rounds", 0.05, {"active_peers": (0, 1, 3)}),
    ("tar_rounds_q", 0.05, {"active_peers": (0, 1, 3)}),
    ("ring_ht", 0.0, {"active_peers": (0, 1, 3)}),
    ("gloo_ring", 0.0, {"shard_weights": (2, 2, 2, 1)}),
    ("optireduce_rounds", 0.0, {"shard_weights": (2, 2, 2, 1)}),
    ("optireduce_rounds", 0.05, {"dead_links": ((1, 2),)}),
])
def test_rounds_and_policies_on_card_match_cpu(dev, strategy, rate, policy):
    """The round schedule, the ring baselines and the participation
    policies: card kernels against CPU plain versions on the same draws,
    every replica (ejected peers included) holding the same bits."""
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=rate, incast=2,
                           drop_pattern="bernoulli", hadamard_block=1024,
                           **policy)
    arena = torch.randn((4, 3, 16_384), generator=torch.Generator()
                        .manual_seed(0))
    for mode in ("scan", "pipelined"):
        want = sync_packed(arena, SyncContext(
            cfg=cfg, draws=_HostDraws(cfg, torch.device("cpu")).inner),
            mode=mode)
        before = (fwht_ops.launches, mm_ops.launches, dq_ops.launches)
        got = sync_packed(arena.to(dev), SyncContext(
            cfg=cfg, draws=_HostDraws(cfg, dev)), mode=mode)
        torch.testing.assert_close(got.cpu(), want, atol=ROT_TOL, rtol=0)
        assert all(torch.equal(got[p], got[0]) for p in range(1, 4))
        launched = [a - b for a, b in zip(
            (fwht_ops.launches, mm_ops.launches, dq_ops.launches), before)]
        rotated = strategy not in ("tar_rounds", "gloo_ring", "nccl_tree",
                                   "bcube")
        assert (launched[0] > 0) == rotated, launched
        if rate > 0:
            assert launched[1] + launched[2] == 3, launched
