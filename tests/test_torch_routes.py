"""Every decode route of gf3x_torch's Modem against gf3x on the CPU: the
δ-warped DFT, the δ-derotated channel estimate, the SC clock-offset
estimator, Schmidl–Cox timing, the clock-offset loop's δ̂, and `decode`
with the chirp and SC syncs, the clock-offset loop, the decision-directed
retry and gf3x's retry policy, on GF3 frames put through gf3x.channel.

Inputs are made with NumPy from a seed and handed to both packages. gf3x
compiles one program per route and recording shape; the recordings of a
config share a length so that its programs are built once."""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gf3x import GF3_HICAP, GF3_STANDARD
from gf3x import Modem as JModem
from gf3x.channel import (awgn, delay_gain, multipath, resample_sfo,
                          room_impulse_response)
from gf3x.ops import chanest as jchan
from gf3x.ops import ofdm as jofdm
from gf3x.ops import sfo as jsfo
from gf3x.ops import sync as jsync

from gf3x_torch import Modem as TModem
from gf3x_torch.models.modem import _median
from gf3x_torch.ops import chanest as tchan
from gf3x_torch.ops import ofdm as tofdm
from gf3x_torch.ops import sfo as tsfo
from gf3x_torch.ops import sync as tsync

import isi_plain

CFG = GF3_STANDARD
ONSET = 2000


def recording(cfg, seed, ppm=0.0, rt60=0.02, drr_db=6.0, snr_db=15.0,
              payload_len=300):
    """One frame of `cfg` through a room, a clock offset, a delay of ONSET
    samples and AWGN: (float32 recording of frame_len + 6000 samples,
    payload)."""
    m = JModem(cfg)
    rng = np.random.default_rng(seed)
    payload = bytes(rng.integers(0, 256, payload_len, dtype=np.uint8))
    x = m.encode(payload, "r.bin").astype(np.float64)
    x = multipath(x, room_impulse_response(rng, rt60=rt60, drr_db=drr_db))
    if ppm:
        x = resample_sfo(x, ppm)
    T = cfg.frame_len + 6000
    rx = delay_gain(x[: T - ONSET], ONSET, 0.5, total_len=T)
    return awgn(rx, snr_db, rng).astype(np.float32), payload


@pytest.fixture(scope="module")
def modems():
    """One gf3x and one port modem per config, shared so that gf3x's
    compiled programs are reused across cases."""
    return {cfg: (JModem(cfg), TModem(cfg, device="cpu")) for cfg in (CFG, GF3_HICAP)}


def frames_at(ppm, B, seed):
    """B frames of CFG at `ppm` with 25 dB AWGN, each cut at its chirp
    onset: (frame windows (B, frame_len) float32)."""
    m = JModem(CFG)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, CFG.payload_bits_per_frame), np.uint8)
    wav = np.asarray(m.modulate_frames(jnp.asarray(info)), np.float64)
    out = []
    for w in wav:
        x = resample_sfo(w, ppm) if ppm else w
        x = np.pad(x, (0, max(0, CFG.frame_len - len(x))))
        out.append(awgn(x[: CFG.frame_len], 25.0, rng))
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------- the ops
@pytest.mark.parametrize("delta", [0.0, 4e-4, -9e-4])
def test_warped_dft_matches(delta):
    """`ofdm_dft(delta=δ)` against gf3x's HIGHEST twin: at config 5 the
    tables are built in float32 in the same order (`warped_angle` below
    UNREDUCED_MAX_ANGLE), so they differ only by the two libraries'
    cos/sin (≤ 1 ulp); max |ΔY| ≤ 1e-4·mean|Y|; and both within the −80
    dB gate of a float64 DFT. The full-float32 product is what keeps it
    there (TF32 would not)."""
    rng = np.random.default_rng(1)
    syms = rng.standard_normal((3, 4, CFG.n_fft)).astype(np.float32)
    ref = np.asarray(jofdm.ofdm_dft(CFG, jnp.asarray(syms),
                                    jnp.float32(delta)))
    got = tofdm.ofdm_dft(CFG, torch.as_tensor(syms),
                         torch.tensor(delta, dtype=torch.float32)).numpy()
    assert got.shape == ref.shape == (3, 4, CFG.n_used)
    assert np.max(np.abs(got - ref)) <= 1e-4 * np.mean(np.abs(ref))
    n = np.arange(CFG.n_fft)[:, None]
    k = np.arange(CFG.bin_lo, CFG.bin_hi + 1)[None, :]
    th = 2 * np.pi / CFG.n_fft * n * k * (1.0 + float(np.float32(delta)))
    exact = syms.astype(np.float64) @ np.exp(-1j * th) / CFG.ofdm_scale
    for y in (got, ref):
        assert 10 * np.log10(np.sum(np.abs(y - exact) ** 2)
                             / np.sum(np.abs(exact) ** 2)) <= -80.0
    body = np.concatenate([np.zeros((3, 4, CFG.cp), np.float32), syms],
                          -1).reshape(3, -1)
    assert np.array_equal(
        tofdm.ofdm_demodulate(CFG, torch.as_tensor(body),
                              torch.tensor(delta)).numpy(), got)


def test_matmul_f32_keeps_tf32_off():
    """The warped DFT's product switches TF32 off for the call and restores
    the caller's setting."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    try:
        mm.allow_tf32 = True
        a = torch.ones(2, 3)
        assert torch.equal(tofdm.matmul_f32(a, a.T), a @ a.T)
        assert mm.allow_tf32
    finally:
        mm.allow_tf32 = prev


@pytest.mark.parametrize("delta", [None, 6e-4])
def test_estimate_channel_delta_matches(delta):
    """`estimate_channel(known, δ)`: Ĥ, noise_var and the ISI profile
    within 1e-4 of their scale (the derotation is float32 on both), all
    against gf3x: on noise alone the port's anchor is gf3x's on every row
    (tests/isi_plain.py)."""
    rng = np.random.default_rng(2)
    K, U = CFG.n_known_symbols, CFG.n_used
    Y = (rng.standard_normal((3, K, U))
         + 1j * rng.standard_normal((3, K, U))).astype(np.complex64)
    d_j = None if delta is None else jnp.float32(delta)
    d_t = None if delta is None else torch.tensor(delta)
    H_r, nv_r, (iv_r, ir_r) = jchan.estimate_channel(CFG, jnp.asarray(Y),
                                                     d_j, with_isi=True)
    H_t, nv_t, (iv_t, ir_t) = tchan.estimate_channel(
        CFG, torch.as_tensor(Y), d_t, with_isi=True)
    assert isi_plain.stays(CFG, *isi_plain.raw_estimate(CFG, Y, delta)).all()
    for got, ref in ((H_t, H_r), (nv_t, nv_r), (iv_t, iv_r), (ir_t, ir_r)):
        ref = np.asarray(ref)
        assert np.max(np.abs(got.numpy() - ref)) <= 1e-4 * np.max(np.abs(ref))


@pytest.mark.parametrize("pool", [False, True])
def test_sc_clock_offset_matches(pool):
    """Coarse δ̂ from the SC windows of frames at 400 ppm (pool off: one per
    row; on: one for the batch): within 0.05 ppm of gf3x, and near the
    truth. Its four half-window products run at full float32."""
    win = frames_at(400.0, 4, 3)
    o = CFG.chirp_len + CFG.cp
    sc = win[:, o: o + CFG.n_fft]
    ref = np.asarray(jsfo.sc_clock_offset(CFG, jnp.asarray(sc), pool=pool))
    got = tsfo.sc_clock_offset(CFG, torch.as_tensor(sc), pool=pool).numpy()
    assert got.shape == ref.shape == (() if pool else (4,))
    assert np.max(np.abs(got - ref)) <= 5e-8
    assert np.all(np.abs(got * 1e6 - 400.0) < 150.0)


def test_retry_policy_is_gf3x_policy():
    """`auto_retry_needed`, `prefer_retry` and the threshold are gf3x's."""
    assert tsfo.SLOPE_PPM_RANGE == jsfo.SLOPE_PPM_RANGE
    for crc in (False, True):
        for ppm in (0.0, -349.0, 351.0, np.array([10.0, -600.0])):
            assert (tsfo.auto_retry_needed(crc, ppm)
                    == jsfo.auto_retry_needed(crc, ppm))
        for retry in (False, True):
            assert (tsfo.prefer_retry(crc, retry)
                    == jsfo.prefer_retry(crc, retry))


@pytest.mark.parametrize("n", [4, 5])
def test_median_interpolates_like_jnp(n):
    """The loop's batch median: jnp.median averages the two middle values
    of an even count (torch.median returns the lower one); equal for odd
    and even counts."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    assert float(_median(torch.as_tensor(x))) == float(jnp.median(x))
    if n % 2 == 0:
        assert float(torch.median(torch.as_tensor(x))) != float(jnp.median(x))


@pytest.mark.parametrize("form", ["prefix_sums", "ones_kernel"])
def test_schmidl_cox_metric_matches(form, monkeypatch):
    """M(d) from prefix sums and, above `_SC_CUMSUM_MAX` (lowered here to
    reach it at a small size), from the ones-kernel correlation: within
    1e-3 absolute (M ≤ 1; the float32 cumsums associate differently in
    torch and XLA, and a window sum is a difference of two of them)."""
    if form == "ones_kernel":
        monkeypatch.setattr(jsync, "_SC_CUMSUM_MAX", 1024)
        monkeypatch.setattr(tsync, "_SC_CUMSUM_MAX", 1024)
    rx, _ = recording(CFG, 7, ppm=300.0)
    rx = np.stack([rx[:20000], rx[3000:23000]])
    ref = np.asarray(jsync.schmidl_cox_metric(CFG, jnp.asarray(rx)))
    got = tsync.schmidl_cox_metric(CFG, torch.as_tensor(rx)).numpy()
    assert got.shape == ref.shape == (2, 20000 - CFG.n_fft)
    assert np.max(np.abs(got - ref)) <= 1e-3


def test_sc_timing_and_metric_at_match():
    """`find_frame_start_sc`: the start within 2 samples (the plateau's
    centre of mass truncates to an int), the peak within 1e-3;
    `sc_metric_at` at those starts within 1e-5."""
    rows = [recording(CFG, s, ppm=p)[0] for s, p in ((7, 300.0), (8, 0.0))]
    rx = np.stack(rows)
    st_r, pk_r = jsync.find_frame_start_sc(CFG, jnp.asarray(rx))
    st_t, pk_t = tsync.find_frame_start_sc(CFG, torch.as_tensor(rx))
    assert st_t.dtype == torch.int32
    assert np.max(np.abs(st_t.numpy() - np.asarray(st_r))) <= 2
    assert np.max(np.abs(pk_t.numpy() - np.asarray(pk_r))) <= 1e-3
    assert np.all(np.abs(st_t.numpy() - ONSET) <= CFG.cp // 4)
    d = np.asarray(st_r) + CFG.chirp_len + CFG.cp
    ref = np.asarray(jsync.sc_metric_at(CFG, jnp.asarray(rx),
                                        jnp.asarray(d)))
    got = tsync.sc_metric_at(CFG, torch.as_tensor(rx),
                             torch.as_tensor(d)).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-5 and np.all(got > 0.5)


def test_two_pass_delta_matches_on_even_batch(modems):
    """The clock-offset loop's shared δ̂ on 4 prewindowed frames at
    −600 ppm (an even batch, so both medians average two values): within
    0.05 ppm of gf3x and within 30 ppm of the truth."""
    jm, tm = modems[CFG]
    win = frames_at(-600.0, 4, 4)
    need = (CFG.n_known_symbols + CFG.n_data_symbols) * CFG.symbol_len
    a = CFG.preamble_len - CFG.cp // 4
    o = CFG.chirp_len + CFG.cp
    body, sc = win[:, a: a + need], win[:, o: o + CFG.n_fft]
    ref = float(jm._two_pass_delta(jm._sym_matrix(jnp.asarray(body)),
                                   jnp.asarray(sc)))
    got = float(tm._two_pass_delta(tm._sym_matrix(torch.as_tensor(body)),
                                   torch.as_tensor(sc)))
    assert abs(got - ref) <= 5e-8
    assert abs(got * 1e6 + 600.0) < 30.0


@pytest.mark.parametrize("delta", [None, 5e-4])
def test_warped_body_demod_matches(modems, delta):
    """`_demod_prewindowed` of 2 frame bodies at 500 ppm, plain and through
    the δ-warped DFT at the true offset, against gf3x's XLA twin: hard
    decisions equal, LLRs within 1e-4·mean|LLR|, slopes within 1e-4
    rad."""
    jm, tm = modems[CFG]
    win = frames_at(500.0, 2, 6)
    need = (CFG.n_known_symbols + CFG.n_data_symbols) * CFG.symbol_len
    a = CFG.preamble_len - CFG.cp // 4
    body = win[:, a: a + need]
    d_j = None if delta is None else jnp.float32(delta)
    d_t = None if delta is None else torch.tensor(delta)
    llr_r, (_, _, sl_r, *_) = jm._demod_prewindowed(
        jnp.asarray(body), use_pallas=False, delta=d_j)
    llr_t, (_, _, sl_t, *_) = tm._demod_prewindowed(torch.as_tensor(body),
                                                    delta=d_t)
    llr_r, llr_t = np.asarray(llr_r), llr_t.numpy()
    assert np.array_equal(llr_t < 0, llr_r < 0)
    assert np.max(np.abs(llr_t - llr_r)) <= 1e-4 * np.mean(np.abs(llr_r))
    assert np.max(np.abs(sl_t.numpy() - np.asarray(sl_r))) <= 1e-4


# ---------------------------------------------------------- decode routes
def test_decode_defaults_are_gf3x_defaults():
    """`decode`'s arguments and defaults are gf3x's (sync='chirp',
    sfo='auto', dd='auto')."""
    sig_t = inspect.signature(TModem.decode).parameters
    sig_j = inspect.signature(JModem.decode).parameters
    assert list(sig_t) == list(sig_j)
    assert all(sig_t[k].default == sig_j[k].default for k in sig_j)
    assert sig_t["sfo"].default == "auto" and sig_t["dd"].default == "auto"


ROUTES = {
    "default": dict(),
    "sfo_on": dict(sfo="on"),
    "dd_on": dict(dd="on"),
    "sc": dict(sync="sc"),
    "plain": dict(sfo="off", dd="off"),
}


def decode_both(modems, cfg, rx, kw):
    jm, tm = modems[cfg]
    return jm.decode(rx, **kw), tm.decode(rx, **kw)


def assert_same(ref, got):
    """Same CRC verdict and unsatisfied-codeword count; where the CRC
    holds, the same payload, and where every codeword converged, the same
    bits. A codeword the LDPC decoder leaves unconverged (a failed frame,
    or padding past a short payload) may end on different words when
    float32 roundings of two libraries differ."""
    assert got.crc_ok == ref.crc_ok
    assert int(got.diag.fec_unsat) == int(ref.diag.fec_unsat)
    if ref.crc_ok:
        assert got.payload == ref.payload and got.filename == ref.filename
    if int(ref.diag.fec_unsat) == 0:
        assert np.array_equal(got.bits, ref.bits)


@pytest.mark.parametrize("route", ["default", "sfo_on", "dd_on", "sc"])
def test_decode_route_matches_gf3x(modems, route):
    """A GF3 frame through a 20 ms room at 300 ppm and 15 dB: the default
    decode and sfo='on', dd='on', sync='sc' each decode it CRC-ok to the
    same bits as gf3x; the SC-synced start within 2 samples of gf3x's,
    clock_ppm within 0.05 ppm."""
    rx, payload = recording(CFG, 7, ppm=300.0)
    ref, got = decode_both(modems, CFG, rx, ROUTES[route])
    assert_same(ref, got)
    assert got.crc_ok and got.payload == payload
    assert abs(int(got.diag.sync_start) - int(ref.diag.sync_start)) <= 2
    assert abs(float(got.diag.clock_ppm) - float(ref.diag.clock_ppm)) <= 0.05


@pytest.mark.parametrize("kw", [dict(sync="sc", sfo="on"),
                                dict(sync="sc", dd="on"),
                                dict(start=ONSET, sfo="on"),
                                dict(start=ONSET, dd="on")],
                         ids=["sc_sfo", "sc_dd", "at_sfo", "at_dd"])
def test_decode_combined_routes(modems, kw):
    """The remaining combinations of sync and retry (held to gf3x through
    their parts above): CRC-ok with the payload, the SC-synced or given
    start within cp/4 of the onset, clock_ppm within 30 ppm of the 300 ppm
    offset."""
    rx, payload = recording(CFG, 7, ppm=300.0)
    got = modems[CFG][1].decode(rx, **kw)
    assert got.crc_ok and got.payload == payload
    assert abs(int(got.diag.sync_start) - ONSET) <= CFG.cp // 4
    assert abs(float(got.diag.clock_ppm) - 300.0) < 30.0


def test_decode_auto_takes_the_sfo_retry(modems):
    """At 900 ppm the plain decode fails (or reports an offset beyond
    SLOPE_PPM_RANGE) and decode(sfo='auto') returns the clock-offset loop's
    decode, as gf3x's does: same bits, CRC ok, clock_ppm ≈ 900."""
    rx, payload = recording(CFG, 9, ppm=900.0, snr_db=20.0)
    plain_r, plain_t = decode_both(modems, CFG, rx, ROUTES["plain"])
    assert_same(plain_r, plain_t)
    assert tsfo.auto_retry_needed(plain_t.crc_ok, plain_t.diag.clock_ppm)
    ref, got = decode_both(modems, CFG, rx, {})
    assert_same(ref, got)
    assert got.crc_ok and got.payload == payload
    assert abs(float(got.diag.clock_ppm) - 900.0) < 30.0


def test_decode_auto_takes_the_dd_retry(modems):
    """gf3-hicap through a 20 ms room with a 0 dB direct-to-reverberant
    ratio at 22 dB: the plain decode and the clock-offset loop both fail
    CRC and the channel shows a tail (isi_db > −25). With sfo='off',
    decode(dd='auto') returns the decision-directed retry, CRC-ok, as
    gf3x's does. With the default sfo='auto' both return the failed
    clock-offset retry: gf3x's policy keeps a retry that failed after a
    plain decode that failed, and returns before the DD retry is reached;
    the port keeps that order."""
    rx, payload = recording(GF3_HICAP, 2, rt60=0.02, drr_db=0.0,
                            snr_db=22.0, payload_len=200)
    for kw in (ROUTES["plain"], dict(sfo="on", dd="off"), {}):
        ref, got = decode_both(modems, GF3_HICAP, rx, kw)
        assert_same(ref, got)
        assert not got.crc_ok
    assert float(got.diag.isi_db) > -25.0
    ref, got = decode_both(modems, GF3_HICAP, rx, dict(sfo="off"))
    assert_same(ref, got)
    assert got.crc_ok and got.payload == payload


def test_decode_rejects_unknown_sync():
    with pytest.raises(ValueError, match="sync"):
        TModem(CFG, device="cpu").decode(np.zeros(CFG.frame_len, np.float32), sync="x")
