"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips itself without a GPU;
this file imports no JAX, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: 1e-5 for a rotation (fp32 adds of
unit-scale values, same order as the plain butterfly), 2e-6 for the
masked mean (at most 4 products summed).
"""
import pytest
import torch

from repro_torch.core.allreduce import OptiReduceConfig, sync_packed
from repro_torch.core.pipeline import GeneratorDraws, SyncContext
from repro_torch.kernels.fwht import ops as fwht_ops
from repro_torch.kernels.fwht import randomized_fwht
from repro_torch.kernels.fwht import ref as fwht_ref
from repro_torch.kernels.masked_sum import masked_mean
from repro_torch.kernels.masked_sum import ops as mm_ops
from repro_torch.kernels.masked_sum.ref import masked_mean_ref

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


@pytest.mark.parametrize("mode", ["scan", "pipelined"])
def test_sync_packed_on_card_matches_cpu(dev, mode):
    """The whole sync path, card kernels against CPU plain versions, with
    the same draws."""
    cfg = OptiReduceConfig(drop_rate=0.05, drop_pattern="bernoulli",
                           hadamard_block=1024)
    cpu = torch.device("cpu")
    arena = torch.randn((4, 3, 16_384), generator=torch.Generator()
                        .manual_seed(0))

    class HostDraws:
        inner = GeneratorDraws((0,), cfg, cpu)

        def sign(self, b, block):
            return self.inner.sign(b, block).to(dev)

        def mask(self, b, r, n, s):
            return self.inner.mask(b, r, n, s).to(dev)

    want = sync_packed(arena, SyncContext(cfg=cfg, draws=HostDraws.inner),
                       mode=mode)
    got = sync_packed(arena.to(dev), SyncContext(cfg=cfg, draws=HostDraws()),
                      mode=mode)
    torch.testing.assert_close(got.cpu(), want, atol=ROT_TOL, rtol=0)
