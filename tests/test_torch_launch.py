"""The port's launcher end to end on the CPU (the plain versions of the
kernels), and its refusal of the reference's flags this slice does not run.
"""
import math

import pytest

from repro_torch.launch import train


def test_smoke_launch_two_steps_on_cpu(capsys):
    records = train.run(["--smoke", "--device", "cpu", "--steps", "2",
                         "--seq-len", "32", "--drop-rate", "0.05",
                         "--log-every", "1"])
    assert len(records) == 2
    for rec in records:
        assert math.isfinite(rec["loss"]) and rec["loss"] > 0
        assert 0 < rec["loss_frac"] < 0.2
        assert rec["skipped"] == 0.0
    assert "done" in capsys.readouterr().out


def test_main_returns_zero_with_scan_and_microbatches():
    assert train.main(["--smoke", "--device", "cpu", "--steps", "1",
                       "--seq-len", "16", "--sync-mode", "scan",
                       "--microbatch", "1", "--strategy", "tar_tcp"]) == 0


@pytest.mark.parametrize("flags,item", [
    (["--transport", "udp"], "A18"),
    (["--recovery", "ef"], "A16"),
    (["--adaptive"], "A17"),
    (["--tp", "2"], "A15"),
    (["--dp-mode", "fsdp"], "A15"),
    (["--ckpt-dir", "ck"], "A12"),
    (["--trace"], "A19"),
    (["--strategy", "tar_rounds_q"], "A14"),
    (["--strategy", "gloo_ring"], "A14"),
    (["--rebalance"], "A17"),
    (["--strategy", "optireduce_2d"], "A15"),
])
def test_unported_flags_raise(flags, item):
    """Flags of later slices raise naming their item; the round schedule
    and the ring baselines of A14 (ported) train one step."""
    argv = ["--smoke", "--device", "cpu", "--steps", "1", *flags]
    if item == "A14":
        records = train.run([*argv, "--seq-len", "16"])
        assert len(records) == 1 and math.isfinite(records[0]["loss"])
        return
    with pytest.raises(NotImplementedError, match=item):
        train.run(argv)


def test_quantized_exchange_two_steps_on_cpu():
    records = train.run(["--smoke", "--device", "cpu", "--steps", "2",
                         "--seq-len", "32", "--strategy", "optireduce_q",
                         "--drop-rate", "0.05", "--log-every", "1"])
    assert len(records) == 2
    for rec in records:
        assert math.isfinite(rec["loss"]) and rec["loss"] > 0
        assert 0 < rec["loss_frac"] < 0.2
        assert math.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0


def test_vmap_sync_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="A7"):
        train.run(["--smoke", "--device", "cpu", "--steps", "1",
                   "--seq-len", "16", "--sync-mode", "vmap"])
