"""Time the rotate kernels (B3 ``ht_amax_f32``, B4 ``ht_quant_grouped_f32``
and B1 ``fwht_f32``) of several kernel trees in turns, on one NVIDIA GPU.
A tree older than the grouped entry point exports B4 as ``ht_quant_f32``,
which takes the same arguments less ``groups``: it is timed through that.
A tree whose entry points take a ``(G, n)`` sign (``sign_groups`` before
the stream) is called with one sign row, the ``(n,)`` form the older trees
take.

    python3 tools/kernel_ab.py LABEL=ROOT ... [--reps N]

Each ``ROOT`` is a checkout's root, or any directory holding
``src/repro_torch/kernels/{ht_quant,fwht}/csrc``. To hold the working tree
against an earlier commit, unpack the commit's kernels into a directory that
``.gitignore`` lists and name both::

    mkdir -p build/ab/old && git archive <commit> src/repro_torch/kernels \\
        | tar -x -C build/ab/old
    python3 tools/kernel_ab.py old=build/ab/old new=.

Every tree's two libraries are built at once (``nvcc``, the port's flags)
into ``build/ab/<label>/``. Each tree's kernels are first held against the
plain PyTorch versions of the working tree (``ht_amax_ref``,
``ht_quant_ref``: bitwise; ``randomized_fwht_ref``: bitwise too, as the
butterfly is the same), then timed with CUDA events at the quantized
exchange's full-width shapes (4 peers of one bucket, 6,553,600 fp32 each,
as blocks of 1024, 2048 and 4096; B1's pre-sign encode of the same rows at
1024), in the order given and back (A, B, B, A).
Prints one JSON line a measurement and one ``{"ab": ...}`` summary line with
each tree's registers a thread (``-Xptxas -v``) beside its times. Exits 1
without a GPU or when a kernel disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PEERS, PEER_BLOCKS, BLOCK = 4, 6_400, 1024      # optireduce_q's full width
BUCKET = PEER_BLOCKS * BLOCK                    # fp32 a peer holds
SIZES = (1024, 2048, 4096)                      # block lengths timed


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
AMAX_ARGS = [_P] * 3 + [_L, _I, _L, _L, _P]
QUANT_ARGS = [_P] * 6 + [_L, _I] + [_L] * 4 + [_I, _P]     # grouped
FWHT_ARGS = [_P] * 3 + [_L, _I, _L, _L, _I, _P]


def _signed(args: list) -> list:
    """An entry point's argument types with the grouped sign's count."""
    return args[:-1] + [_I, args[-1]]


def _one_sign_row(fn, *args):
    """A grouped-sign entry point called with one sign row."""
    return fn(*args[:-1], 1, args[-1])


def build_tree(label: str, root: Path) -> dict:
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "ab" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, pkg in (("ht_quant", "ht_quant"), ("fwht", "fwht")):
        src = root / "src/repro_torch/kernels" / pkg / "csrc" / f"{name}.cu"
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, regs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc failed on {name}.cu\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        regs.update({e: r for e, r in build.registers(log).items()
                     if any(f"ILi{k}E" in e for k in (10, 11, 12))})
    fwht_src = root / "src/repro_torch/kernels/fwht/csrc/fwht.cu"
    return {"libs": libs, "registers": regs,
            "signs": "sign_groups" in fwht_src.read_text()}


def _one_group(fn, *args):
    """``ht_quant_grouped_f32`` called with the one-group arguments of the
    older ``ht_quant_f32`` (``groups`` = 1 before ``bits``)."""
    return fn(*args[:11], 1, *args[11:])


def bind(libs: dict, signs: bool):
    def typed(fn, args):
        fn.argtypes = _signed(args) if signs else args
        fn.restype = ctypes.c_int
        return functools.partial(_one_sign_row, fn) if signs else fn
    fns = {}
    lib = libs["ht_quant"]
    fns["ht_amax_f32"] = typed(lib.ht_amax_f32, AMAX_ARGS)
    if hasattr(lib, "ht_quant_grouped_f32"):
        fns["ht_quant"] = functools.partial(
            _one_group, typed(lib.ht_quant_grouped_f32, QUANT_ARGS))
    else:
        fns["ht_quant"] = typed(lib.ht_quant_f32,
                                QUANT_ARGS[:11] + QUANT_ARGS[12:])
    fns["fwht_f32"] = typed(libs["fwht"].fwht_f32, FWHT_ARGS)
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="LABEL=ROOT")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, time_ms
    from repro_torch.kernels.fwht import ref as fwht_ref
    from repro_torch.kernels.ht_quant import ref as hq_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"card": smi})
    trees = {}
    for spec in args.trees:
        label, _, root = spec.partition("=")
        try:
            trees[label] = build_tree(label, (ROOT / root).resolve())
        except RuntimeError as e:          # the other trees still run
            emit({"tree": label, "build_error": str(e)[-6000:]})
            continue
        trees[label]["fns"] = bind(trees[label]["libs"],
                                   trees[label]["signs"])

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases, bounds = {}, {}
    for n in SIZES:
        per_peer = BUCKET // n
        rows = PEERS * per_peer
        arena = torch.randn((PEERS, 2, BUCKET), generator=gen, device=dev)
        c = {"n": n, "per_peer": per_peer, "rows": rows,
             "x": arena[:, 1].view(PEERS, per_peer, n)}
        c["sign"] = torch.where(
            torch.rand((n,), generator=gen, device=dev) < 0.5, 1.0, -1.0)
        c["noise"] = torch.rand((per_peer, n), generator=gen, device=dev)
        c["amax_want"] = hq_ref.ht_amax_ref(c["x"], c["sign"])
        shared = torch.clamp(c["amax_want"].amax(0), min=1e-12)
        c["lo"], c["step"] = -shared, 2.0 * shared / 255
        c["codes_want"] = hq_ref.ht_quant_ref(c["x"], c["sign"], c["noise"],
                                              c["lo"], c["step"], bits=8)
        c["amax"] = torch.empty((PEERS, per_peer), device=dev)
        c["codes"] = torch.empty(c["x"].shape, dtype=torch.uint8, device=dev)
        cases[n] = c
        bounds[f"ht_amax@{n}"] = bound(hq_ref.ht_amax_bytes(rows, n),
                                       hq_ref.ht_amax_flops(rows, n))[0]
        bounds[f"ht_quant@{n}"] = bound(
            hq_ref.ht_quant_bytes(rows, n, per_peer, per_peer),
            hq_ref.ht_quant_flops(rows, n))[0]
    frows = PEERS * PEER_BLOCKS
    xf = torch.randn((frows, BLOCK), generator=gen, device=dev)
    sign = cases[BLOCK]["sign"]
    fwht_want = fwht_ref.randomized_fwht_ref(xf, sign, mode="encode")
    fout = torch.empty_like(xf)
    bounds["fwht_pre@1024"] = bound(fwht_ref.fwht_bytes(frows, BLOCK),
                                    fwht_ref.fwht_flops(frows, BLOCK))[0]

    def calls(fns):
        out = {}
        for n, c in cases.items():
            x = c["x"]
            out[f"ht_amax@{n}"] = functools.partial(
                fns["ht_amax_f32"], x.data_ptr(), c["sign"].data_ptr(),
                c["amax"].data_ptr(), c["rows"], n, c["per_peer"],
                x.stride(0), stream)
            out[f"ht_quant@{n}"] = functools.partial(
                fns["ht_quant"], x.data_ptr(), c["sign"].data_ptr(),
                c["noise"].data_ptr(), c["lo"].data_ptr(),
                c["step"].data_ptr(), c["codes"].data_ptr(), c["rows"], n,
                c["per_peer"], x.stride(0), c["per_peer"], 8, stream)
        out["fwht_pre@1024"] = functools.partial(
            fns["fwht_f32"], xf.data_ptr(), fout.data_ptr(), sign.data_ptr(),
            frows, BLOCK, frows, 0, 1, stream)
        return out

    ok = True
    for label, tree in trees.items():
        tree["calls"] = calls(tree["fns"])
        fout.fill_(float("nan"))
        for c in cases.values():
            c["amax"].fill_(float("nan"))
            c["codes"].zero_()
        errs = {name: call() for name, call in tree["calls"].items()}
        torch.cuda.synchronize()
        if any(errs.values()):
            raise RuntimeError(f"{label}: launch errors {errs}")
        equal = {"fwht_pre@1024": torch.equal(fout, fwht_want)}
        for n, c in cases.items():
            equal[f"ht_amax@{n}"] = torch.equal(c["amax"], c["amax_want"])
            equal[f"ht_quant@{n}"] = torch.equal(c["codes"], c["codes_want"])
        emit({"tree": label, "bitwise_equal_plain": equal,
              "registers": tree["registers"]})
        ok &= all(equal.values())
    order = list(trees) + list(reversed(trees))
    times: dict = {label: {name: [] for name in bounds} for label in trees}
    for label in order:
        for name, call in trees[label]["calls"].items():
            ms = time_ms(call, reps=args.reps, warmup=5)
            times[label][name].append(ms)
            emit({"tree": label, "kernel": name, "ms": ms})
    summary = {label: {name: {"ms": t, "bound_ms": bounds[name],
                              "share": bounds[name] * len(t) / sum(t)}
                       for name, t in times[label].items()}
               | {"registers": trees[label]["registers"]}
               for label in trees}
    emit({"ab": summary, "card": smi, "order": order})
    return 0 if ok and len(trees) == len(args.trees) else 1


if __name__ == "__main__":
    sys.exit(main())
