"""The port's kernel call path on the CPU: the binding (`utils/device.py`
and `csrc/binding.cu`), kernel 2's launch geometry and per-config
constants, and the port's copy of bench.py's batch recipe
(`gf3x_torch.bench.step.build_batch`, which chip_smoke.py uses).

The kernels themselves run only on the card (`chip_smoke.py`); what is
held here is everything around a launch that Python decides."""

import ast
import re
from collections import Counter

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from gf3x_torch import GF3_FAST, GF3_STANDARD, GF3_TURBO, Modem
from gf3x_torch.bench import step
from gf3x_torch.config import layout
from gf3x_torch.ops import constellation
from gf3x_torch.ops.kernels import eq_layout, fused_eq, split_eq
from gf3x_torch.utils import device

LONGCP = GF3_STANDARD.replace(n_fft=2048, cp=512, bin_lo=48, bin_hi=607)
WIDE = GF3_STANDARD.replace(n_fft=4096, cp=1024, bin_lo=48, bin_hi=1071)


def test_chip_smoke_build_batch_is_bench_build_batch():
    """The port's own `build_batch` (`gf3x_torch.bench.step`, which
    chip_smoke.py and `gf3x-torch bench` build their batches with; it
    imports nothing of the JAX side) gives bench.py's batch bit for bit."""
    modem = Modem(GF3_STANDARD, max_delay=4096 + GF3_STANDARD.cp,
                  device="cpu")
    got = step.build_batch(modem, 4, 4096, np.random.default_rng(0))
    via = chip_smoke.build_batch(modem, 4, 4096, np.random.default_rng(0))
    assert all(np.array_equal(a, b) for a, b in zip(got, via))
    ref = bench.build_batch(modem, 4, 4096, np.random.default_rng(0))
    assert got[0].dtype == ref[0].dtype == np.float32
    assert np.array_equal(got[0], ref[0])
    assert got[1] == ref[1]
    assert np.array_equal(got[2], ref[2])


class _Entry:
    """Returns its codes in turn, the last one from then on."""

    def __init__(self, *rcs):
        self.rcs, self.calls = list(rcs), []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rcs.pop(0) if len(self.rcs) > 1 else self.rcs[0]


class _Library:
    """A kernel library that records each lookup of an entry: one entry
    that launches, one that fails, one that finds another device current
    the first time."""

    def __init__(self):
        self.entries = {"gf3x_ok": _Entry(0), "gf3x_bad": _Entry(700),
                        "gf3x_moved": _Entry(device._OTHER_DEVICE, 0)}
        self.resolved = []

    def __getattr__(self, name):
        if name in self.__dict__.get("entries", {}):
            self.resolved.append(name)
            return self.entries[name]
        raise AttributeError(name)

    def gf3x_error_string(self, rc):
        return f"stub error {rc}"


def test_launch_resolves_an_entry_once_and_raises_on_error(monkeypatch):
    """`launch` looks an entry up once over two calls and hands it the
    device's current stream and the device; where the entry finds another
    device current, `launch` switches to the tensors' device and calls it
    again; a non-zero code raises with the library's error string. No card
    is needed."""
    lib = _Library()
    switched = []

    class _Device:
        def __init__(self, index):
            switched.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(device, "kernel_lib", lambda: lib)
    monkeypatch.setattr(device, "_ENTRIES", {})
    monkeypatch.setattr(device, "_raw_stream", lambda index: 4242 + index)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    device.launch("gf3x_ok", 0, 1, 2.5)
    device.launch("gf3x_ok", 0, 3, 4.5)
    assert lib.resolved == ["gf3x_ok"]
    assert lib.entries["gf3x_ok"].calls == [(1, 2.5, 4242, 0),
                                            (3, 4.5, 4242, 0)]
    assert switched == []
    device.launch("gf3x_moved", 1, 5)
    assert switched == [1]
    assert lib.entries["gf3x_moved"].calls == [(5, 4243, 1)] * 2
    with pytest.raises(RuntimeError,
                       match="gf3x_bad: CUDA error 700: stub error 700"):
        device.launch("gf3x_bad", 0, 7)
    assert lib.entries["gf3x_bad"].calls == [(7, 4242, 0)]


def _kinds(params: str) -> str:
    """'p' address, 'f' float, 'l' integer, per C parameter."""
    out = []
    for prm in params.split(","):
        prm = prm.strip()
        out.append("p" if "*" in prm else
                   "f" if re.match(r"(const\s+)?float\b", prm) else "l")
    return "".join(out)


def _entries():
    """{entry: parameter kinds} of every GF3X_EXPORT definition, and
    binding.cu's [(entry, format, call macro kinds, call indices)]."""
    defs = {}
    for src in device.CSRC.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r"GF3X_EXPORT\s+[\w\s\*]+?\b(gf3x_\w+)\s*"
                             r"\((.*?)\)\s*\{", text, re.S):
            defs[m.group(1)] = _kinds(m.group(2))
    binding = (device.CSRC / "binding.cu").read_text()
    ents = []
    for m in re.finditer(r'ENTRY\((\w+), "(\w+)",\s*\w+\((.*?)\)\)\n',
                         binding, re.S):
        calls = re.findall(r"\b([PLIF])\((\d+)\)", m.group(3))
        kinds = "".join({"P": "p", "L": "l", "I": "l", "F": "f"}[k]
                        for k, _ in calls)
        ents.append((m.group(1), m.group(2), kinds,
                     [int(i) for _, i in calls]))
    return defs, ents


def _launch_calls():
    """{entry: [argument count of each launch call in the wrappers]}."""
    counts = {}
    for src in (device.CSRC.parent / "ops" / "kernels").glob("*.py"):
        for node in ast.walk(ast.parse(src.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "launch"):
                name = node.args[0].value
                counts.setdefault(name, []).append(len(node.args) - 2)
    return counts


def test_binding_matches_every_entry_and_wrapper():
    """Each C entry has a trampoline in binding.cu whose format gives every
    parameter its kind (address, integer, float) in order, whose call reads
    the converted arguments in that order, and each wrapper's `launch`
    passes the entry's arguments but the stream (`launch` appends it and
    the device). The CUDA compiler would not catch a float read as an
    integer, and this machine has none."""
    defs, ents = _entries()
    calls = _launch_calls()
    assert {name for name, *_ in ents} == set(defs) - {"gf3x_error_string"}
    assert set(calls) == set(defs) - {"gf3x_error_string"}
    for name, fmt, kinds, order in ents:
        assert fmt == kinds == defs[name], name
        assert order == list(range(len(fmt))), name
        assert fmt[-1] == "p", name                 # the stream
        assert calls[name] == [len(fmt) - 1] * len(calls[name]), name
    # the code an entry returns when its device is not the current one
    binding = (device.CSRC / "binding.cu").read_text()
    assert re.search(r"kOtherDevice = (-?\d+);", binding).group(1) \
        == str(device._OTHER_DEVICE)


CONFIGS = {"config5": GF3_STANDARD, "gf3-fast": GF3_FAST,
           "gf3-turbo": GF3_TURBO, "gf3-longcp": LONGCP, "n_used-1024": WIDE,
           **{name: GF3_STANDARD.replace(**kw)
              for name, kw in chip_smoke.WIDE_BANDS.items()}}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_eq_geometry_covers_every_symbol_once(name):
    """Kernel 2's launch and kernel A's, which has its layout, each cover
    every (frame, data symbol) exactly once and keep a block within 227 KB
    of shared memory, at the batches the port runs (one recording, odd
    batches, 1024): staged (one block per frame, warp w taking data
    symbols w, w + W, ..., every warp a symbol) at the narrow bands, and
    teamed — a team of warps per symbol, a frame's symbols spread over
    blocks, every block a symbol — at the wide ones (whose staged layout
    holds too few warps an SM, or fits none: gf3-16384)."""
    cfg = CONFIGS[name]
    D, U, P = cfg.n_data_symbols, cfg.n_used, cfg.n_pilots
    assert name != "n_used-1024" or U == 1024
    for demap in (True, False):
        for B in (1, 7, 8, 64, 1023, 1024, 4096):
            geo = eq_layout.fused_eq_geometry(cfg, B, demap=demap)
            per_slot = [list(geo.symbols(g, D, blk))
                        for blk in range(geo.blocks)
                        for g in range(geo.teams)]
            seen = Counter((b, d) for b in range(B) for syms in per_slot
                           for d in syms)
            assert len(seen) == B * D and set(seen.values()) == {1}
            assert all(len(s) <= geo.passes for s in per_slot)
            assert 1 <= geo.warps <= 32
            assert geo.layout == ("teamed" if name in chip_smoke.WIDE_BANDS
                                  else "staged")
            # the kernels' layouts, in floats: Ĥ, the symbol buffers, |Ĥ|²
            # and the pilot scratch; kernel 2 adds 1/max(|Ĥ|², 1e-12), the
            # warps' sums and the layout table (U ints), kernel A the pilot
            # positions (P ints) (fused_eq.cu, split_eq.cu); teamed, the
            # teams' pilot scratch and three shared values, kernel 2's sums
            # and the pilot positions, and Ĥ (with kernel 2's table) where
            # it is staged
            if geo.layout == "teamed":
                assert geo.nbuf == 0
                floats = (5 * U if demap else 3 * U) if geo.stage_h else 0
                floats += 4 * P * geo.teams + 4 * geo.teams
                floats += 2 * geo.warps if demap else 0
                floats += 0 if geo.stage_h and demap else P
                assert all(any(geo.symbols(g, D, blk)
                               for g in range(geo.teams))
                           for blk in range(geo.blocks))
            else:
                assert all(1 <= len(s) for s in per_slot)
                assert geo.nbuf == (2 if geo.passes > 1 else 1)
                floats = (2 * U + 2 * U * geo.warps * geo.nbuf + U
                          + 4 * P * geo.warps)
                floats += U + 2 * geo.warps + U if demap else P
            assert geo.smem == 4 * floats <= 232_448
        # one recording: a symbol per warp, where a narrow band lets the
        # block hold D warps
        if name not in chip_smoke.WIDE_BANDS:
            assert eq_layout.fused_eq_geometry(cfg, 1,
                                               demap=demap).passes == 1
    # without the demap's rows a block of kernel A needs less
    geoA = eq_layout.fused_eq_geometry(cfg, 1024, demap=False)
    assert geoA.smem < eq_layout.staged_smem_bytes(U, P, geoA.warps,
                                                   geoA.nbuf)


LOADED = GF3_STANDARD.replace(bit_loading=tuple(
    int(x) for x in np.random.default_rng(chip_smoke.LOADING_SEED).choice(
        [0, 2, 4, 6], size=GF3_STANDARD.n_data_bins, p=chip_smoke.LOADING_P)))


@pytest.mark.parametrize("name", list(CONFIGS) + ["bit-loaded"])
def test_demap_geometry_covers_every_symbol_once(name):
    """Kernel B's launch (kernel 2's layout over the wire-order slots):
    every (frame, data symbol) once, every warp a symbol, and a block's
    shared memory — per warp its eq rows and LLR row, each rounded up to
    16 bytes, then the slot table (two words a slot), a float per slot and
    the levels (split_eq.cu) — within 227 KB, at the batches the port runs;
    streamed (gf3-16384, whose 64-QAM row fits no warp count), the levels
    alone."""
    cfg = LOADED if name == "bit-loaded" else CONFIGS[name]
    D, U = cfg.n_data_symbols, cfg.n_used
    R, NS = cfg.bits_per_ofdm_symbol, cfg.n_active_bins
    for B in (1, 7, 1024, 4096):
        geo = eq_layout.demap_geometry(cfg, B)
        seen = Counter((b, d) for b in range(B) for w in range(geo.warps)
                       for d in geo.symbols(w, D))
        assert len(seen) == B * D and set(seen.values()) == {1}
        assert all(geo.symbols(w, D) for w in range(geo.warps))
        assert (geo.layout == "streamed") == (name == "gf3-16384")
        if geo.layout == "streamed":
            assert geo.nbuf == 0 and geo.smem == 4 * 16
            continue
        assert geo.nbuf == (2 if geo.passes > 1 else 1)
        per_warp = (geo.nbuf * -(-2 * U // 4) * 4) + -(-R // 4) * 4
        assert geo.smem == 4 * (geo.warps * per_warp + 3 * NS + 16)
        assert geo.smem <= 232_448


@pytest.mark.parametrize("cfg", [GF3_STANDARD, GF3_FAST, GF3_TURBO, LONGCP],
                         ids=["qpsk", "16qam", "64qam", "longcp"])
def test_launch_constants_are_the_configs(cfg):
    """Kernel 2's per-config constants, computed once per config, equal
    `track_constants(cfg)`, the levels `qam_demap_llr` demaps with, and
    the divisors of evm and mabs; the cached pilot floats are the config's
    pilot values."""
    got = fused_eq.launch_constants(cfg)
    assert got is fused_eq.launch_constants(cfg)
    track, levels, addr, evm_div, abs_div = got
    assert track == split_eq.track_constants(cfg)
    ref = constellation._levels(cfg.bits_per_symbol, "cpu").numpy()
    assert levels.dtype == np.float32 and np.array_equal(levels, ref)
    assert addr == levels.ctypes.data
    assert evm_div == cfg.n_data_symbols * cfg.n_data_bins
    assert abs_div == cfg.raw_bits_per_frame
    pv = split_eq.pilot_floats(cfg, torch.device("cpu"))
    assert torch.equal(torch.view_as_complex(pv),
                       torch.as_tensor(layout(cfg).pilot_vals))
