"""The gf3x_torch slice end to end against gf3x on the CPU: the transmit
waveform, the config-5 batched `demodulate` (bench.py's workload at B = 4),
`decode` of a recorded fixture, the static tables, and the package's
independence from jax.

gf3x compiles two `demodulate` programs in this file (bounded and
unbounded sync); each is built once per module."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from gf3x import GF3_STANDARD
from gf3x import Modem as JModem
from gf3x.config import layout
from gf3x.fec.ldpc import LdpcCode
from gf3x.io import read_wav
from gf3x.models.frame import interleave_bits, loading_tables
from gf3x.ops.chanest import _isi_operator, denoise_projection
from gf3x.ops.chirp import make_chirp

from gf3x_torch import Modem as TModem
from gf3x_torch.convert import TABLES, load_reference_tables

CFG = GF3_STANDARD
MAX_DELAY = bench.MARGIN + CFG.cp
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def batch():
    """bench.build_batch at B = 4, decoded once by gf3x (bounded sync)."""
    jm = JModem(CFG, max_delay=MAX_DELAY)
    rx, payload, delays = bench.build_batch(jm, 4, bench.MARGIN,
                                            np.random.default_rng(0))
    bits, diag = jm._decode_jit(jnp.asarray(rx))
    return rx, payload, delays, np.asarray(bits), jax.device_get(diag)


def gf3x_tables(cfg):
    """gf3x's static tables as NumPy arrays, under the port's names."""
    lay = layout(cfg)
    M, q, _ = _isi_operator(cfg)
    nd = cfg.n_data_bins
    if cfg.bit_loading is None:
        groups = ((cfg.bits_per_symbol, np.arange(nd)),)
    else:
        groups = loading_tables(cfg).groups
    bits, off, base = np.zeros(nd, np.int32), np.zeros(nd, np.int32), 0
    for m, pos in groups:
        bits[pos] = m
        off[pos] = base + m * np.arange(len(pos))
        base += m * len(pos)
    return {
        "chirp": make_chirp(cfg),
        "known_syms": lay.known_syms,
        "pilot_vals": lay.pilot_vals,
        "sc_sym": lay.sc_sym,
        "scramble": lay.scramble,
        "denoise": denoise_projection(cfg),
        "isi_M": M,
        "isi_q": q,
        "ldpc_parity": LdpcCode.for_config(cfg).t.P,
        "fec_index": np.asarray(interleave_bits(
            cfg, np.arange(cfg.raw_bits_per_frame), inverse=True)),
        "demap_used": lay.data_pos.astype(np.int32),
        "demap_bits": bits,
        "demap_off": off,
    }


def test_encode_waveform_matches():
    """One frame, bytes → waveform: ≤ 1e-5 abs (float32 irfft in two FFT
    libraries; the chirp, bits and symbols are exact)."""
    jm, tm = JModem(CFG), TModem(CFG, device="cpu")
    payload = np.random.default_rng(1).integers(0, 256, 300, np.uint8).tobytes()
    ref = jm.encode(payload, "a.bin")
    got = tm.encode(payload, "a.bin")
    assert got.shape == ref.shape == (CFG.frame_len,)
    assert np.max(np.abs(got - ref)) <= 1e-5
    info = np.stack([tm._info_bits(payload, "a.bin"),
                     tm._info_bits(b"x", "b")])
    assert np.array_equal(
        tm.fec_encode(torch.as_tensor(info)).numpy(),
        np.asarray(jm.fec_encode(jnp.asarray(info))))


def test_demodulate_batch_matches_gf3x(batch):
    """Config-5 path on bench.build_batch(B=4): payload bits exact and CRC
    ok on every row; diagnostics within stated tolerances — sync_start
    within the decimation step (2), H / noise_var / isi_var ≤ 1e-3 rel,
    slope/cpe ≤ 1e-4 rad, evm and mean|LLR| ≤ 1e-3 rel, fec_unsat exact,
    fec_iters ≤ ldpc_iters (per codeword here, batch-wide in gf3x)."""
    rx, payload, delays, j_bits, jd = batch
    tm = TModem(CFG, max_delay=MAX_DELAY, device="cpu")
    bits, d = tm.demodulate(torch.as_tensor(rx))
    bits = bits.numpy()
    assert np.array_equal(bits, j_bits)
    for b in bits:
        res = tm._result(b, None)
        assert res.crc_ok and res.payload == payload
    assert np.max(np.abs(d.sync_start.numpy() - np.asarray(jd.sync_start))) <= 2
    Hj = np.asarray(jd.H)[..., 0] + 1j * np.asarray(jd.H)[..., 1]

    def rel(a, b):
        return np.max(np.abs(a - b)) / np.max(np.abs(b))

    assert rel(d.H.numpy(), Hj) <= 1e-3
    assert rel(d.noise_var.numpy(), np.asarray(jd.noise_var)) <= 1e-3
    assert rel(d.isi_var.numpy(), np.asarray(jd.isi_var)) <= 1e-3
    assert np.max(np.abs(d.pilot_slope.numpy()
                         - np.asarray(jd.pilot_slope))) <= 1e-4
    assert np.max(np.abs(d.common_phase.numpy()
                         - np.asarray(jd.common_phase))) <= 1e-4
    assert np.allclose(d.evm.numpy(), np.asarray(jd.evm), rtol=1e-3)
    assert np.allclose(d.mean_abs_llr.numpy(), np.asarray(jd.mean_abs_llr),
                       rtol=1e-3)
    assert np.allclose(d.sc_metric.numpy(), np.asarray(jd.sc_metric),
                       rtol=1e-3)
    assert np.array_equal(d.fec_unsat.numpy(), np.asarray(jd.fec_unsat))
    assert (d.fec_iters.numpy() <= CFG.ldpc_iters).all()
    assert np.array_equal(d.llr_hist.numpy().sum(-1),
                          np.asarray(jd.llr_hist).sum(-1))
    assert np.abs(d.llr_hist.numpy() - np.asarray(jd.llr_hist)).sum() <= 4


def test_tables_bit_exact_and_loadable(batch):
    """The port's self-built tables equal gf3x's bit for bit, and a port
    modem loaded from gf3x's tables decodes identically."""
    tm = TModem(CFG, max_delay=MAX_DELAY, device="cpu")
    ref = gf3x_tables(CFG)
    assert set(ref) == set(TABLES)
    for name, arr in ref.items():
        buf = tm.get_buffer(name).numpy()
        assert buf.dtype == np.asarray(arr).dtype, name
        assert np.array_equal(buf, arr), name

    loaded = TModem(CFG, max_delay=MAX_DELAY, device="cpu")
    for name in ("known_syms", "denoise"):          # prove the copy lands
        loaded.get_buffer(name).zero_()
    load_reference_tables(loaded, ref)
    rx = torch.as_tensor(batch[0])
    b0, d0 = tm.demodulate(rx)
    b1, d1 = loaded.demodulate(rx)
    assert torch.equal(b0, b1) and torch.equal(d0.H, d1.H)
    with pytest.raises(ValueError):
        load_reference_tables(loaded, {"isi_q": ref["isi_q"][:-1]})
    with pytest.raises(KeyError):
        load_reference_tables(loaded, {"weights": ref["isi_q"]})


def test_decode_recorded_fixture_matches():
    """`decode(rx, sfo='off', dd='off')` of a recorded room capture through
    both implementations (unbounded sync): the same bits, CRC ok."""
    rx, _ = read_wav(REPO / "tests" / "fixtures" / "gf3_single_room.wav")
    ref = JModem(CFG).decode(rx, sfo="off", dd="off")
    got = TModem(CFG, device="cpu").decode(rx, sfo="off", dd="off")
    assert got.crc_ok and ref.crc_ok
    assert np.array_equal(got.bits, ref.bits)
    assert got.payload == ref.payload and got.filename == ref.filename
    assert abs(int(got.diag.sync_start) - int(ref.diag.sync_start)) <= 2


@pytest.mark.parametrize("preset", ["gf3", "loopback"])
def test_known_start_roundtrip(preset):
    """`demodulate_at` on a clean frame at a known onset, LDPC-coded and
    uncoded: the payload comes back CRC-ok, every codeword satisfied."""
    from gf3x_torch import preset as t_preset

    tm = TModem(t_preset(preset), device="cpu")
    payload = b"known start " * 8
    wav = tm.encode(payload, "k.bin")
    rx = np.concatenate([np.zeros(300, np.float32), wav,
                         np.zeros(2000, np.float32)])
    res = tm.decode(rx, start=300)
    assert res.crc_ok and res.payload == payload and res.filename == "k.bin"
    assert int(res.diag.sync_start) == 300
    assert int(res.diag.fec_unsat) == 0


def test_import_leaves_jax_out():
    """Importing the whole port loads neither jax nor gf3x (the machine
    with the card has no jax)."""
    code = ("import sys, gf3x_torch, gf3x_torch.convert, "
            "gf3x_torch.utils.device, gf3x_torch.ops.kernels.gather_cut, "
            "gf3x_torch.ops.kernels.fused_eq, gf3x_torch.ops.kernels.ldpc_bp, "
            "gf3x_torch.ops.kernels.split_eq, gf3x_torch.ops.kernels.cut_dft, "
            "gf3x_torch.ops.adapt, gf3x_torch.ops.sfo, gf3x_torch.ops.sync, "
            "gf3x_torch.models.stream, gf3x_torch.io, gf3x_torch.io.audio, "
            "gf3x_torch.utils.captures, gf3x_torch.models.arq, "
            "gf3x_torch.channel, gf3x_torch.channel.sims;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gf3x')];"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_modem_on_the_card_by_default():
    """A `Modem` without a device puts its buffers on the card, and raises
    as torch raises where there is none; `device="cpu"` (a string or a
    torch.device) is the explicit CPU route."""
    from gf3x_torch import preset as t_preset

    cfg = t_preset("loopback")
    if torch.cuda.is_available():
        assert TModem(cfg).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            TModem(cfg)
    for dev in ("cpu", torch.device("cpu")):
        m = TModem(cfg, device=dev)
        assert m.device.type == "cpu"
        assert all(b.device.type == "cpu" for b in m.buffers())


def test_uninterleaved_config_roundtrip():
    """A config that sends its coded bits uninterleaved (`interleave=False`)
    decodes: the port's wire-to-stream index is the identity there, as
    gf3x's `coded_stream_llr` skips its deinterleaver; the coded-stream
    LLRs' signs equal gf3x's."""
    from gf3x import preset as j_preset
    from gf3x_torch import preset as t_preset

    tm = TModem(t_preset("gf3").replace(interleave=False), device="cpu")
    jm = JModem(j_preset("gf3").replace(interleave=False))
    payload = b"no interleaver " * 4
    wav = tm.encode(payload, "u.bin")
    assert np.max(np.abs(wav - jm.encode(payload, "u.bin"))) <= 1e-5
    rx = np.concatenate([np.zeros(300, np.float32), wav,
                         np.zeros(2000, np.float32)])
    res = tm.decode(rx, start=300, sfo="off")
    assert res.crc_ok and res.payload == payload
    assert np.array_equal(tm.coded_llrs(rx, 300) < 0,
                          jm.coded_llrs(rx, 300) < 0)
