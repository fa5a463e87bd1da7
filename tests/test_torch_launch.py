"""The port's launcher end to end on the CPU (the plain versions of the
kernels), and each ROADMAP item's flags training through it.
"""
import math

import pytest
import torch

from repro_torch.launch import train


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke model is too small to gain from torch's intra-op threads,
    and under the suite's parallel workers those threads contend for the
    cores; one thread a test, the worker's setting restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



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
    (["--transport", "inproc"], "A18"),
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
    (["--recovery", "ef+budget"], "A16"),
    (["--resume"], "A12"),
])
def test_unported_flags_raise(flags, item, tmp_path, monkeypatch):
    """Flags of later slices raise naming their item; those of the ported
    items train one step: the round schedule and the ring baselines (A14),
    FSDP and ``optireduce_2d`` (A15; on one pod the 2D strategy runs as
    ``optireduce``), the control plane (A17), the tracer (A19, writing into
    the working directory), loss recovery (A16), checkpoints (A12, a
    ``--resume`` with nothing to resume starting at step 0), the host wire
    (A18: ``tests/test_torch_net_launch.py`` holds it to the reference)
    and tensor parallelism (``--tp 2``, A15b)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--smoke", "--device", "cpu", "--steps", "1", *flags]
    if item in ("A12", "A14", "A15", "A16", "A17", "A18", "A19"):
        records = train.run([*argv, "--seq-len", "16"])
        assert len(records) == 1 and math.isfinite(records[0]["loss"])
        assert (tmp_path / "trace_rank00.json").exists() == (item == "A19")
        assert ("filled" in records[0]) == (item == "A16")
        assert ("wire_loss_frac" in records[0]) == (item == "A18")
        assert (tmp_path / "ck" / "step_00000001").exists() == \
            ("--ckpt-dir" in flags)
        return
    with pytest.raises(NotImplementedError, match=item):
        train.run(argv)


@pytest.mark.parametrize("flags", [
    ["--tp", "2", "--dp", "2"],
    ["--production-mesh", "--global-batch", "16"],
    ["--tp", "2", "--dp", "2", "--dp-mode", "fsdp"]])
def test_tensor_parallel_flags_name_a15b(flags, capsys):
    """The tensor-parallel flags of A15b train: ``--tp 2`` beside the data
    peers, the production mesh (16 x 16 ``(data, model)``: gpt2-smoke's
    heads padded 4 -> 16, one KV head a shard, vocab 512 / 16) and FSDP x
    TP, one step each on the CPU."""
    records = train.run(["--smoke", "--device", "cpu", "--steps", "1",
                         "--seq-len", "16", "--drop-rate", "0.05", *flags])
    assert len(records) == 1
    assert math.isfinite(records[0]["loss"]) and records[0]["loss"] > 0
    assert math.isfinite(records[0]["grad_norm"])
    mesh = ("{'data': 16, 'model': 16}" if "--production-mesh" in flags
            else "{'data': 2, 'model': 2}")
    assert f"mesh={mesh}" in capsys.readouterr().out


def test_transport_with_tp_refuses_as_the_reference():
    """``--transport`` with ``--tp`` > 1 is refused before anything runs,
    with the reference's message."""
    with pytest.raises(SystemExit):
        train.run(["--smoke", "--device", "cpu", "--steps", "1", "--tp",
                   "2", "--dp", "2", "--transport", "udp"])


def test_fsdp_launch_two_steps_on_cpu(capsys):
    """``--dp-mode fsdp`` through the launcher: the reduce-scatter reduces
    the sharded weights, the norms' bucket gives ``loss_frac``."""
    records = train.run(["--smoke", "--device", "cpu", "--steps", "2",
                         "--seq-len", "32", "--dp-mode", "fsdp",
                         "--drop-rate", "0.01", "--microbatch", "1",
                         "--log-every", "1"])
    assert len(records) == 2
    for rec in records:
        assert math.isfinite(rec["loss"]) and rec["loss"] > 0
        assert math.isfinite(rec["grad_norm"])
    assert "done" in capsys.readouterr().out


def test_fsdp_with_recovery_raises():
    with pytest.raises(ValueError, match="dp_mode='replicated'"):
        train.run(["--smoke", "--device", "cpu", "--steps", "1",
                   "--seq-len", "16", "--dp-mode", "fsdp", "--recovery",
                   "stale"])


def test_recovery_over_quantized_codes_raises():
    with pytest.raises(ValueError, match="linear codec"):
        train.run(["--smoke", "--device", "cpu", "--steps", "1",
                   "--seq-len", "16", "--recovery", "ef", "--strategy",
                   "optireduce_q"])


def test_quantized_exchange_two_steps_on_cpu():
    records = train.run(["--smoke", "--device", "cpu", "--steps", "2",
                         "--seq-len", "32", "--strategy", "optireduce_q",
                         "--drop-rate", "0.05", "--log-every", "1"])
    assert len(records) == 2
    for rec in records:
        assert math.isfinite(rec["loss"]) and rec["loss"] > 0
        assert 0 < rec["loss_frac"] < 0.2
        assert math.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0


@pytest.mark.parametrize("strategy", ["optireduce", "optireduce_q"])
def test_vmap_sync_mode_is_not_ported(strategy):
    """``--sync-mode vmap`` (ROADMAP A7, now ported) trains bit for bit as
    ``scan`` does: the batched sync is the per-bucket one, bucket for
    bucket (tests/test_torch_vmap.py holds every strategy)."""
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
            "--drop-rate", "0.05", "--strategy", strategy]
    keys = ("loss", "grad_norm", "loss_frac", "skipped")
    batched = [{k: r[k] for k in keys}
               for r in train.run([*argv, "--sync-mode", "vmap"])]
    serial = [{k: r[k] for k in keys}
              for r in train.run([*argv, "--sync-mode", "scan"])]
    assert batched == serial
    assert all(r["loss_frac"] > 0 for r in batched)
