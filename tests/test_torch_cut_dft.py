"""Kernel 8's plain version (the fused cut + used-band DFT + deroll of
gf3x_torch) against gf3x's Pallas `cut_dft_tpu` in interpret mode and
against the port's own two-stage chain, and the `use_cut_dft` route of the
port's Modem against gf3x's default route, on the CPU.

The CUDA kernel runs only on the card: `chip_smoke.py` holds it against
this plain version there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from gf3x import GF3_STANDARD
from gf3x import Modem as JModem
from gf3x.ops.sync import cut_dft_spectra as j_cut_dft_spectra

from gf3x_torch import Modem as TModem
from gf3x_torch.ops import sync as tsync
from gf3x_torch.ops.kernels import cut_dft as tcut
from gf3x_torch.ops.ofdm import deroll, ofdm_dft

CFG = GF3_STANDARD
S = CFG.n_known_symbols + CFG.n_data_symbols
SC_OFF = CFG.cp + CFG.cp // 4 + 64
MAX_DELAY = bench.MARGIN + CFG.cp


def random_cut(B, seed, spread=1024):
    """B noise recordings and cut bases over `spread` samples of onset."""
    rng = np.random.default_rng(seed)
    T = CFG.frame_len + spread
    rx = rng.standard_normal((B, T)).astype(np.float32)
    base = (rng.integers(0, spread, B) + CFG.chirp_len
            - CFG.cp // 4).astype(np.int32)
    return rx, base


def test_cut_dft_plain_matches_pallas_interpret():
    """gf3x's `cut_dft_spectra(interpret=True)` (bf16x3 Pallas kernel,
    span-staged, B = 8) relaid from its lanes layout to (B, S, U), against
    the port's `cut_dft_spectra` on the CPU: ‖ΔY‖/‖Y‖ < 5e-5, the
    reference's own on-chip gate for this kernel (bf16x3 floor ≈ 1e-5);
    the SC window is sample-exact."""
    rx, base = random_cut(8, 3)
    Yl, scw_r = j_cut_dft_spectra(
        CFG, jnp.asarray(rx), jnp.asarray(base), S=S, body_off=CFG.sc_len,
        sc_off=SC_OFF, max_start_span=1024 + 128, interpret=True)
    Yl = np.asarray(Yl)
    ref = (Yl[:, 0] + 1j * Yl[:, 1]).transpose(2, 0, 1)        # (B, S, U)
    Y, scw = tsync.cut_dft_spectra(CFG, torch.as_tensor(rx),
                                   torch.as_tensor(base), S=S,
                                   body_off=CFG.sc_len, sc_off=SC_OFF)
    assert Y.shape == ref.shape == (8, S, CFG.n_used)
    assert Y.dtype == torch.complex64
    rel = np.linalg.norm(Y.numpy() - ref) / np.linalg.norm(ref)
    assert rel < 5e-5, rel
    assert np.array_equal(scw.numpy(), np.asarray(scw_r))


@pytest.mark.parametrize("sc_off", [SC_OFF, -1])
def test_cut_dft_spectra_is_the_two_stage_chain(sc_off):
    """On the CPU the fused wrapper gives exactly kernel 1's cut → DFT →
    deroll at an odd batch, past the recording's end included; with
    sc_off < 0 there is no SC window (None, where gf3x's TPU kernel leaves
    its buffer unwritten)."""
    rx, base = random_cut(3, 5)
    base[0] = rx.shape[1] - 100                      # runs past the end
    rx_t, base_t = torch.as_tensor(rx), torch.as_tensor(base)
    geo = dict(S=S, body_off=CFG.sc_len, sc_off=sc_off, block=128)
    Y, scw = tsync.cut_dft_spectra(CFG, rx_t, base_t, **geo)
    syms, scw2, roll = tsync.cut_symbols(rx_t, base_t, n_fft=CFG.n_fft,
                                         sym_len=CFG.symbol_len, cp=CFG.cp,
                                         **geo)
    assert torch.equal(Y, deroll(CFG, ofdm_dft(CFG, syms), roll))
    if sc_off < 0:
        assert scw is None and scw2 is None
    else:
        assert torch.equal(scw, scw2)


def test_cut_dft_refuses_tensors_off_the_cpu_and_card():
    """The dispatch rule: only a CPU tensor takes the plain version; any
    other device launches the kernel or raises (here: no CUDA device)."""
    rx, base = random_cut(2, 6)
    q = torch.zeros(2, dtype=torch.int32)
    kw = dict(valid=rx.shape[1], block=128, S=S, body_off=CFG.sc_len,
              sc_off=SC_OFF)
    with pytest.raises(ValueError, match="CUDA"):
        tcut.cut_dft(CFG, torch.as_tensor(rx, device="meta"), q.to("meta"),
                     q.to("meta"), **kw)


def test_twiddle_table_is_exactly_rounded():
    """The kernel's cos/sin table of 2πj/N equals the float64 values
    rounded once to float32."""
    tw = tcut.twiddles(CFG.n_fft, torch.device("cpu")).numpy()
    th = 2 * np.pi * np.arange(CFG.n_fft) / CFG.n_fft
    assert tw.dtype == np.float32 and tw.shape == (2, CFG.n_fft)
    assert np.array_equal(tw[0], np.cos(th).astype(np.float32))
    assert np.array_equal(tw[1], np.sin(th).astype(np.float32))


def test_deroll_against_gf3x_ramp():
    """The port's deroll (k·roll reduced mod N in integers, kernel 8's
    twiddle index) against gf3x's `_deroll` (float32 product (2π/N)·roll·k)
    at every roll of the 128-sample block grid and every used bin, up to
    k·roll ≈ 236 rad: the two ramps differ by at most 3e-5 rad (measured
    2.1e-5: gf3x's float32 angle, whose ulp there is 1.5e-5 rad), and the
    port's stays within 1e-6 rad of the float64 ramp."""
    jm = JModem(CFG)
    Y = np.ones((128, 1, CFG.n_used), np.complex64)
    roll = np.arange(128, dtype=np.int32)
    ref = np.asarray(jm._deroll(jnp.asarray(Y), jnp.asarray(roll)))
    got = deroll(CFG, torch.as_tensor(Y), torch.as_tensor(roll)).numpy()
    assert np.max(np.abs(np.angle(got * np.conj(ref)))) <= 3e-5
    k = np.arange(CFG.bin_lo, CFG.bin_hi + 1)
    exact = np.exp(2j * np.pi * k * roll[:, None, None].astype(np.float64)
                   / CFG.n_fft)
    assert np.max(np.abs(np.angle(got * np.conj(exact)))) <= 1e-6
    assert np.max(np.abs(got)) <= 1 + 1e-6


def test_use_cut_dft_demodulate_matches_gf3x():
    """`Modem(use_cut_dft=True).demodulate` on bench.build_batch(B = 4)
    against gf3x's default route: payload bits exact and CRC ok; H,
    noise_var ≤ 1e-3 rel, slope/cpe ≤ 1e-4 rad, evm and mean|LLR| ≤ 1e-3
    rel (the slice's tolerances); and against the port's two-stage route,
    the same bits and H within 1e-5 rel."""
    jm = JModem(CFG, max_delay=MAX_DELAY)
    rx, payload, _ = bench.build_batch(jm, 4, bench.MARGIN,
                                       np.random.default_rng(0))
    j_bits, jd = jm._decode_jit(jnp.asarray(rx))
    jd = jax.device_get(jd)
    fused = TModem(CFG, max_delay=MAX_DELAY, use_cut_dft=True, device="cpu")
    two = TModem(CFG, max_delay=MAX_DELAY, device="cpu")
    assert fused.use_cut_dft and not two.use_cut_dft
    bits, d = fused.demodulate(torch.as_tensor(rx))
    bits2, d2 = two.demodulate(torch.as_tensor(rx))
    assert np.array_equal(bits.numpy(), np.asarray(j_bits))
    assert torch.equal(bits, bits2)
    for b in bits.numpy():
        res = fused._result(b, None)
        assert res.crc_ok and res.payload == payload

    def rel(a, b):
        return np.max(np.abs(a - b)) / np.max(np.abs(b))

    Hj = np.asarray(jd.H)[..., 0] + 1j * np.asarray(jd.H)[..., 1]
    assert rel(d.H.numpy(), Hj) <= 1e-3
    assert rel(d.noise_var.numpy(), np.asarray(jd.noise_var)) <= 1e-3
    assert np.max(np.abs(d.pilot_slope.numpy()
                         - np.asarray(jd.pilot_slope))) <= 1e-4
    assert np.max(np.abs(d.common_phase.numpy()
                         - np.asarray(jd.common_phase))) <= 1e-4
    assert np.allclose(d.evm.numpy(), np.asarray(jd.evm), rtol=1e-3)
    assert np.allclose(d.mean_abs_llr.numpy(), np.asarray(jd.mean_abs_llr),
                       rtol=1e-3)
    assert np.allclose(d.sc_metric.numpy(), np.asarray(jd.sc_metric),
                       rtol=1e-3)
    assert rel(d.H.numpy(), d2.H.numpy()) <= 1e-5


def test_use_cut_dft_routes_only_the_plain_decode(monkeypatch):
    """The fused route takes the plain decode only: with the flag set,
    `demodulate` never cuts a symbol matrix, while the clock-offset loop
    and the DD retry still do (they re-demodulate it)."""
    m = TModem(CFG, use_cut_dft=True, device="cpu")
    wav = m.encode(b"route", "r.bin")
    rx = torch.as_tensor(np.concatenate([np.zeros(500, np.float32), wav,
                                         np.zeros(3000, np.float32)]))
    cuts = []
    real = m._cut_frame
    monkeypatch.setattr(m, "_cut_frame",
                        lambda *a: cuts.append(1) or real(*a))
    for fn, n_cuts in ((m.demodulate, 0), (m.demodulate_sfo, 1),
                       (m.demodulate_dd, 1)):
        cuts.clear()
        bits, _ = fn(rx)
        res = m._result(bits.numpy(), None)
        assert res.crc_ok and res.payload == b"route"
        assert len(cuts) == n_cuts, fn.__name__


# ---- kernel 8's launch plan (`cut_dft_geometry`), checked here because the
# kernel itself runs only on the card

N_FFTS = [128, 256, 512, 1024, 2048, 4096]


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_cut_dft_geometry_is_legal(n_fft):
    """Every n_fft the wrapper accepts gets a launch the kernel can run, at
    the segment counts the port gives it: the radices are 8s
    then at most one 2 or 4 and multiply to M = n_fft/2, each divides the
    points a thread holds, a team is 8-32 lanes of one warp or a pair of
    warps, a team walks at most SEGMENTS_PER_TEAM segments where the block
    fits, a block has at most 512 threads (15 pairs, one named barrier each) and its shared
    memory is the kernel's layout within 227 KB; a
    window buffer holds the pass exchange (one pad slot per 8 points) and
    the aligned 16-byte chunks covering n_fft samples; the butterflies a
    team's threads run cover each of a pass's M/R butterflies once."""
    M = n_fft // 2
    for nseg in (1, 2, 7, 24, 25, 41):
        geo = tcut.cut_dft_geometry(n_fft, nseg)
        assert int(np.prod(geo.radices)) == M
        assert all(r == 8 for r in geo.radices[:-1])
        assert geo.radices[-1] in (2, 4, 8) and geo.radices[0] == 8
        assert geo.tail == (1 if geo.radices[-1] == 8 else geo.radices[-1])
        assert all(geo.points % r == 0 for r in geo.radices)
        assert geo.points * geo.team == M
        assert geo.team in (8, 16, 32, 64)
        assert geo.threads <= 512 and 1 <= geo.teams <= nseg
        assert geo.team <= 32 or geo.teams <= 15
        passes = -(-nseg // geo.teams)
        buf = tcut.buffer_floats(n_fft)
        # more segments a team only where the teams for one fewer would
        # not fit
        more = -(-nseg // (passes - 1)) if passes > 1 else geo.teams
        assert (passes <= tcut.SEGMENTS_PER_TEAM
                or 8 * n_fft + more * 2 * 4 * buf > 232_448
                or more * geo.team > 512)
        assert geo.nbuf == (2 if passes > 1 else 1)
        assert geo.smem == 8 * n_fft + geo.teams * geo.nbuf * 4 * buf
        assert geo.smem <= 232_448
        slots = np.arange(M) + np.arange(M) // 8
        assert np.unique(slots).size == M and 2 * (slots.max() + 1) <= buf
        assert n_fft + 4 <= buf
        for R in geo.radices:
            js = [tl + b * geo.team for tl in range(geo.team)
                  for b in range(geo.points // R)]
            assert sorted(js) == list(range(M // R))
    with pytest.raises(ValueError):
        tcut.cut_dft_geometry(8192, 25)


def _dft_small(v, R):
    """The kernel's in-register DFT of R = 2, 4 or 8 points (radix-8 as two
    DFT-4s and the exactly rounded e^{−2πik/8}), natural order, float32."""
    if R == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if R == 4:
        t0, t1 = v[0] + v[2], v[0] - v[2]
        t2, t3 = v[1] + v[3], (v[1] - v[3]) * -1j
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    c = np.float32(np.sqrt(0.5))
    E, O = _dft_small(v[0::2], 4), _dft_small(v[1::2], 4)
    O = [O[0], O[1] * complex(c, -c), O[2] * -1j, O[3] * complex(-c, -c)]
    return [E[i] + O[i] for i in range(4)] + [E[i] - O[i] for i in range(4)]


def emulate_cut_dft_passes(x, n_fft, bin_lo, n_used, roll):
    """The kernel's FFT in float32 torch, pass by pass with the twiddle
    table and its integer indices: x (B, n_fft) samples → derolled used
    bins (B, n_used), unscaled."""
    N, M = n_fft, n_fft // 2
    cs, sn = tcut.twiddles(N, torch.device("cpu"))
    z = torch.complex(x[:, 0::2], x[:, 1::2])
    Ns = 1
    for R in tcut.cut_dft_geometry(N, 1).radices:
        j = torch.arange(M // R)
        k = j & (Ns - 1)
        v = [z[:, j + r * (M // R)] for r in range(R)]
        if Ns > 1:
            for r in range(1, R):
                idx = k * r * (N // (Ns * R))
                v[r] = v[r] * torch.complex(cs[idx], -sn[idx])
        out = torch.empty_like(z)
        d = (j - k) * R + k
        for r, X in enumerate(_dft_small(v, R)):
            out[:, d + r * Ns] = X
        z, Ns = out, Ns * R
    kk = bin_lo + torch.arange(n_used)
    za, zb = z[:, kk & (M - 1)], z[:, (M - kk) & (M - 1)].conj()
    X = 0.5 * (za + zb) + torch.complex(cs[kk], -sn[kk]) * (-0.5j) * (za - zb)
    ridx = (kk[None] * roll[:, None]) & (N - 1)
    return X * torch.complex(cs[ridx], sn[ridx])


@pytest.mark.parametrize("n_fft", [128, 256, 1024, 2048, 4096])
def test_cut_dft_passes_emulated_match_float64(n_fft):
    """The kernel's passes emulated in float32 (same radices, butterflies,
    twiddle indices, unpacking and deroll) against a float64 NumPy rfft
    with the exact deroll ramp: ≤ −120 dB (the card's gate is −80 dB; float32
    lands near −138 dB)."""
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((4, n_fft)).astype(np.float32)
    roll = rng.integers(0, 128, 4)
    lo, hi = n_fft // 32, n_fft // 2
    got = emulate_cut_dft_passes(torch.as_tensor(x), n_fft, lo, hi - lo + 1,
                                 torch.as_tensor(roll)).numpy()
    k = np.arange(lo, hi + 1)
    ref = (np.fft.rfft(x.astype(np.float64))[:, lo: hi + 1]
           * np.exp(2j * np.pi * k * roll[:, None] / n_fft))
    db = 10 * np.log10(np.sum(np.abs(got - ref) ** 2)
                       / np.sum(np.abs(ref) ** 2))
    assert db <= -120.0, db
