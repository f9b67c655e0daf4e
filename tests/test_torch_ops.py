"""gf3x_torch ops against their gf3x counterparts on the CPU.

Each test feeds the same numpy inputs (made from a seed) to the gf3x
function and to its port, and states its tolerance. "rel" is
max|port − ref| / max|ref|."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gf3x import GF3_STANDARD
from gf3x.ops import chanest as jchan
from gf3x.ops import constellation as jcon
from gf3x.ops import ofdm as jofdm
from gf3x.ops import sync as jsync
from gf3x.ops.chirp import make_chirp
from gf3x.models import frame as jframe

from gf3x_torch.ops import chanest as tchan
from gf3x_torch.ops import constellation as tcon
from gf3x_torch.ops import ofdm as tofdm
from gf3x_torch.ops import sync as tsync
from gf3x_torch.ops.sfo import slope_clock_offset
from gf3x_torch.models import frame as tframe

import isi_plain

CFG = GF3_STANDARD


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("bps", [2, 4, 6])
def test_qam_map_and_demap_match(bps):
    """Map: exact (same table lookups). Demap: ≤ 1e-5 rel (float32
    min/subtract/divide, identical operation order)."""
    rng = np.random.default_rng(bps)
    bits = rng.integers(0, 2, (64, 7, bps), dtype=np.uint8)
    ref = np.asarray(jcon.qam_map(jnp.asarray(bits), bps))
    got = tcon.qam_map(torch.as_tensor(bits), bps).numpy()
    assert np.array_equal(got, ref)

    y = (ref + 0.2 * crandn(rng, *ref.shape)).astype(np.complex64)
    nv = rng.uniform(0.01, 0.5, ref.shape).astype(np.float32)
    ref_l = np.asarray(jcon.qam_demap_llr(jnp.asarray(y), jnp.asarray(nv), bps))
    got_l = tcon.qam_demap_llr(torch.as_tensor(y), torch.as_tensor(nv),
                               bps).numpy()
    assert got_l.shape == ref_l.shape == (64, 7, bps)
    assert rel(got_l, ref_l) <= 1e-5
    assert np.array_equal(tcon.hard_bits(torch.as_tensor(got_l)).numpy(),
                          np.asarray(jcon.hard_bits(jnp.asarray(ref_l))))


@pytest.mark.parametrize("inverse", [False, True])
def test_interleave_bits_matches(inverse):
    """The v3 channel-bit interleaver, both directions: exact."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, CFG.raw_bits_per_frame)).astype(np.float32)
    ref = np.asarray(jframe.interleave_bits(CFG, jnp.asarray(x), inverse))
    got = tframe.interleave_bits(CFG, torch.as_tensor(x), inverse).numpy()
    assert np.array_equal(got, ref)
    back = tframe.interleave_bits(CFG, torch.as_tensor(got), not inverse)
    assert np.array_equal(back.numpy(), x)


def test_frame_assembly_matches():
    """Pilot interleave/split and the K+D frame bin matrix: exact."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (2, CFG.raw_bits_per_frame), dtype=np.uint8)
    ref = np.asarray(jframe.frame_bin_matrix(
        CFG, jframe.data_symbols_from_bits(CFG, jnp.asarray(bits))))
    got = tframe.frame_bin_matrix(
        CFG, tframe.data_symbols_from_bits(CFG, torch.as_tensor(bits))).numpy()
    assert np.array_equal(got, ref)
    pil, dat = tframe.split_pilots(CFG, torch.as_tensor(got))
    rpil, rdat = jframe.split_pilots(CFG, jnp.asarray(ref))
    assert np.array_equal(pil.numpy(), np.asarray(rpil))
    assert np.array_equal(dat.numpy(), np.asarray(rdat))


def test_ofdm_modulate_and_dft_match():
    """irfft + CP and the used-band rfft: ≤ 1e-5 rel (two float32 FFT
    libraries)."""
    rng = np.random.default_rng(5)
    S = CFG.n_known_symbols + CFG.n_data_symbols
    X = crandn(rng, 2, S, CFG.n_used)
    ref = np.asarray(jofdm.ofdm_modulate(CFG, jnp.asarray(X)))
    got = tofdm.ofdm_modulate(CFG, torch.as_tensor(X)).numpy()
    assert got.shape == ref.shape == (2, S * CFG.symbol_len)
    assert rel(got, ref) <= 1e-5

    sym = rng.standard_normal((2, S, CFG.n_fft)).astype(np.float32)
    ref_y = np.asarray(jofdm.ofdm_dft(CFG, jnp.asarray(sym)))
    got_y = tofdm.ofdm_dft(CFG, torch.as_tensor(sym)).numpy()
    assert got_y.shape == ref_y.shape == (2, S, CFG.n_used)
    assert rel(got_y, ref_y) <= 1e-5


# the warped DFT's bands: config 5 and chip_smoke.py's WIDE_BANDS; at
# gf3-16384 its top 512 bins, where the angle is largest (the whole band's
# float64 tables would take gigabytes here)
WARPED_BANDS = {
    1024: {},
    4096: dict(n_fft=4096, cp=1024, bin_lo=96, bin_hi=1215),
    8192: dict(n_fft=8192, cp=2048, bin_lo=192, bin_hi=2431),
    16384: dict(n_fft=16384, cp=4096, bin_lo=7488, bin_hi=7999),
}


@pytest.mark.parametrize("n_fft", sorted(WARPED_BANDS))
def test_warped_dft_holds_float64_at_every_band(n_fft):
    """`ofdm_dft(delta=δ)` at δ = 0, 1.5e-4 and −9e-4 against a float64
    DFT. At the wide bands ≤ −110 dB: n·k is reduced mod N in int64
    before the angle and the warp n·k·δ keeps float32's relative accuracy
    (`warped_angle`), where gf3x's float32 (2π/N)·n·k·(1+δ) gives −79 to
    −62 dB. At config 5, whose angles stay under UNREDUCED_MAX_ANGLE, the
    table is gf3x's product bit for bit, within the −80 dB gate."""
    from gf3x_torch import GF3_STANDARD as T_STANDARD

    cfg = T_STANDARD.replace(**WARPED_BANDS[n_fft])
    reduced = 2 * np.pi * cfg.bin_hi >= tofdm.UNREDUCED_MAX_ANGLE
    assert reduced == (n_fft > 1024)
    rng = np.random.default_rng(6)
    syms = rng.standard_normal((2, 2, n_fft)).astype(np.float32)
    n = np.arange(n_fft)[:, None]
    for delta in map(np.float32, (0.0, 1.5e-4, -9e-4)):
        got = tofdm.ofdm_dft(cfg, torch.as_tensor(syms),
                             torch.tensor(delta)).numpy()
        assert got.shape == (2, 2, cfg.n_used)
        if not reduced:
            th = (np.float32(2 * np.pi / n_fft) * n.astype(np.float32)
                  * np.arange(cfg.bin_lo, cfg.bin_hi + 1,
                              dtype=np.float32)[None, :]
                  * (np.float32(1.0) + delta))
            assert torch.equal(tofdm.warped_angle(cfg, delta, "cpu"),
                               torch.as_tensor(th))
            assert torch.equal(tofdm.unreduced_angle(cfg, delta, "cpu"),
                               torch.as_tensor(th))
        err = sig = 0.0
        for k0 in range(cfg.bin_lo, cfg.bin_hi + 1, 512):
            k = np.arange(k0, min(k0 + 512, cfg.bin_hi + 1))
            th = 2 * np.pi / n_fft * n * k[None, :] * (1.0 + float(delta))
            exact = (syms.astype(np.float64) @ np.exp(-1j * th)
                     / cfg.ofdm_scale)
            err += np.sum(np.abs(got[..., k - cfg.bin_lo] - exact) ** 2)
            sig += np.sum(np.abs(exact) ** 2)
        db = 10 * np.log10(err / sig)
        assert db <= (-110.0 if reduced else -80.0), (n_fft, delta, db)


CZT_BANDS = [n for n in sorted(WARPED_BANDS) if n > 1024]


def float64_dft_db(cfg, syms, delta, got) -> float:
    """got's error in dB against the δ-warped used-band DFT of syms
    (..., n_fft) in float64, 512 bins at a time."""
    n = np.arange(cfg.n_fft)[:, None]
    err = sig = 0.0
    for k0 in range(cfg.bin_lo, cfg.bin_hi + 1, 512):
        k = np.arange(k0, min(k0 + 512, cfg.bin_hi + 1))
        th = 2 * np.pi / cfg.n_fft * n * k[None, :] * (1.0 + float(delta))
        exact = syms.astype(np.float64) @ np.exp(-1j * th) / cfg.ofdm_scale
        err += np.sum(np.abs(got[..., k - cfg.bin_lo] - exact) ** 2)
        sig += np.sum(np.abs(exact) ** 2)
    return 10 * np.log10(err / sig)


def _strided_symbols(cfg, seed):
    """Two recordings of two symbols each, CP-stripped through a strided
    view as the cut leaves them (row stride n_fft + cp)."""
    rng = np.random.default_rng(seed)
    body = rng.standard_normal((2, 2 * cfg.symbol_len)).astype(np.float32)
    view = torch.as_tensor(body).reshape(2, 2, cfg.symbol_len)[..., cfg.cp:]
    assert not view.is_contiguous()
    return view


@pytest.mark.parametrize("delta", [0.0, 1.5e-4, -9e-4, 1e-3])
@pytest.mark.parametrize("n_fft", CZT_BANDS)
def test_czt_holds_float64(n_fft, delta):
    """The chirp-z transform's chain (`czt_chain`: `czt_pre`, the FFT, the
    product with H, the inverse, `czt_post`, in their plain versions;
    `czt_dft` takes it at any L the fused kernel is not built for) against
    a float64 DFT at ≤ −125 dB, on symbols read through a strided view as
    the cut leaves them (row stride n_fft + cp): tables in float64 rounded
    once, the FFTs in float32."""
    from gf3x_torch import GF3_STANDARD as T_STANDARD

    cfg = T_STANDARD.replace(**WARPED_BANDS[n_fft])
    assert tofdm.takes_czt(cfg)
    view = _strided_symbols(cfg, 7)
    d = torch.tensor(np.float32(delta))
    pre, post, H = tofdm.chirp_tables(cfg, d, "cpu", tofdm.czt_length(cfg))
    got = tofdm.czt_chain(view, pre, H, post)
    assert got.shape == (4, cfg.n_used) and got.dtype == torch.complex64
    got = got.reshape(2, 2, cfg.n_used)
    db = float64_dft_db(cfg, view.numpy(), np.float32(delta), got.numpy())
    assert db <= -125.0, (n_fft, delta, db)


@pytest.mark.parametrize("delta", [0.0, 1.5e-4, -9e-4, 1e-3])
@pytest.mark.parametrize("n_fft", CZT_BANDS)
def test_czt_fused_holds_float64(n_fft, delta):
    """The fused kernel's plain version (`czt_fused_plain`, which
    `ofdm_dft(delta=δ)` runs at every wide band: its radix-3 and radix-2^b
    stages, the digit-reversed product with H, the inverse stages, in
    float32) against a float64 DFT at ≤ −125 dB, on the cut's strided
    view."""
    from gf3x_torch import GF3_STANDARD as T_STANDARD
    from gf3x_torch.ops.kernels import czt

    cfg = T_STANDARD.replace(**WARPED_BANDS[n_fft])
    L = tofdm.czt_length(cfg)
    assert czt.takes_fused(L, cfg.n_fft, cfg.n_used)
    view = _strided_symbols(cfg, 7)
    d = torch.tensor(np.float32(delta))
    got = tofdm.czt_dft(cfg, view, d)
    assert got.shape == (2, 2, cfg.n_used) and got.dtype == torch.complex64
    assert torch.equal(tofdm.ofdm_dft(cfg, view, d), got)
    pre, post, H = tofdm.chirp_tables(cfg, d, "cpu", L)
    assert torch.equal(czt.czt_fused_plain(view, pre, czt.filter_table(H),
                                           post).reshape(got.shape), got)
    db = float64_dft_db(cfg, view.numpy(), np.float32(delta), got.numpy())
    assert db <= -125.0, (n_fft, delta, db)


@pytest.mark.parametrize("n_fft", CZT_BANDS)
def test_czt_fused_matches_the_chain(n_fft):
    """The fused kernel's plain version against the chain's on the same
    tables, at δ = 1.5e-4 and −9e-4, on whole rows and on rows 99 samples
    short: ≤ −125 dB of the chain's energy (two float32 computations of
    one exact transform)."""
    from gf3x_torch import GF3_STANDARD as T_STANDARD
    from gf3x_torch.ops.kernels import czt

    cfg = T_STANDARD.replace(**WARPED_BANDS[n_fft])
    L = tofdm.czt_length(cfg)
    view = _strided_symbols(cfg, 8)
    n = cfg.n_fft - 99     # rows shorter than the padding leaves room for
    for delta in map(np.float32, (1.5e-4, -9e-4)):
        pre, post, H = tofdm.chirp_tables(cfg, torch.tensor(delta), "cpu", L)
        for x, p in ((view, pre), (view[..., :n], pre[:n])):
            fused = czt.czt_fused_plain(x, p, czt.filter_table(H), post)
            chain = tofdm.czt_chain(x, p, H, post)
            db = 10 * np.log10(float((fused - chain).abs().pow(2).sum()
                                     / chain.abs().pow(2).sum()))
            assert db <= -125.0, (n_fft, delta, x.shape[-1], db)


def test_czt_route_is_chosen_by_length(monkeypatch):
    """`czt_dft` takes the fused kernel at the lengths it is built for
    (6144, 12 288, 24 576: the three wide bands) where N ≤ 2L/3 and
    M ≤ L/3, and the chain at any other L, a length not built (16 384) or
    one whose block would not fit in shared memory (49 152, past
    SMEM_BLOCK); both give the transform."""
    from gf3x_torch import GF3_STANDARD as T_STANDARD
    from gf3x_torch.ops.kernels import czt
    from gf3x_torch.utils.device import SMEM_BLOCK

    assert [tofdm.czt_length(T_STANDARD.replace(**WARPED_BANDS[n]))
            for n in CZT_BANDS] == list(czt.FUSED_LENGTHS)
    for n, L in zip(CZT_BANDS, czt.FUSED_LENGTHS):
        c = T_STANDARD.replace(**WARPED_BANDS[n])
        assert czt.takes_fused(L, c.n_fft, c.n_used)
        assert czt.fused_smem_bytes(L) <= SMEM_BLOCK
        # the radix-3 stages' pruning: N ≤ 2L/3 in, M ≤ L/3 out
        assert czt.takes_fused(L, 2 * L // 3, L // 3)
        assert not czt.takes_fused(L, 2 * L // 3 + 1, L // 3)
        assert not czt.takes_fused(L, 2 * L // 3, L // 3 + 1)
    assert czt.fused_smem_bytes(12288) == 8 * (12288 + 768 + 64 + 192 + 256)
    assert czt.fused_smem_bytes(49152) > SMEM_BLOCK
    for L in (16384, 49152, 3 << 20, 4096):
        assert not czt.takes_fused(L, L // 2, L // 8)
    cfg = T_STANDARD.replace(**WARPED_BANDS[8192])
    view = _strided_symbols(cfg, 9)
    d = torch.tensor(np.float32(1.5e-4))
    taken = []
    for name in ("czt_fused", "czt_chain"):
        real = getattr(tofdm, name)
        monkeypatch.setattr(tofdm, name, lambda *a, _f=real, _n=name: (
            taken.append(_n), _f(*a))[1])
    fused = tofdm.czt_dft(cfg, view, d)
    chain = tofdm.czt_dft(cfg, view, d, 16384)
    assert taken == ["czt_fused", "czt_chain"]
    for got in (fused, chain):
        db = float64_dft_db(cfg, view.numpy(), np.float32(1.5e-4),
                            got.numpy())
        assert db <= -125.0, db


@pytest.mark.parametrize("L", [6144, 12288, 24576])
def test_fused_stages_and_twiddles(L):
    """The fused kernel's factorisation: its radices multiply to L, radix 3
    first and radix 16 last; the twiddle table's entries are e^{−2πie/L}
    (the fine ones at their swizzled slots) and e^{−2πi·kq/256} (at
    [k][q]) rounded once, coarse·fine reaches every ω_L^e
    within 2.5e-7, and every stage's twiddle ω_S^{qk} as the kernel forms
    it is within 5e-7;
    `digit_reversed` is the order the forward stages leave the spectrum
    in (the plain forward stages of a unit impulse at bin k put 1 at the
    position holding k), and `filter_table` holds it as the kernel reads
    it."""
    from gf3x_torch.ops.kernels import czt

    rad = czt.fused_radices(L)
    assert rad[0] == 3 and rad[-1] == 16 and int(np.prod(rad)) == L
    assert set(rad[1:]) <= {2, 4, 8, 16} and rad.count(16) >= len(rad) - 2
    tab = czt.twiddle_table(L, "cpu").numpy().astype(np.complex128)
    slots = czt._fine_slot(np.arange(64))
    assert sorted(slots) == list(range(64))
    kq = np.outer(np.arange(16), np.arange(16)).ravel()   # [k][q]
    assert np.abs(tab[slots] - np.exp(-2j * np.pi * np.arange(64) / L)
                  ).max() <= 6e-8
    e = np.concatenate([64 * np.arange(L // 64), L // 256 * kq])
    assert np.abs(tab[64:] - np.exp(-2j * np.pi * e / L)).max() <= 6e-8
    for R, S, W, tw in czt._fused_stages(L, "cpu"):
        assert (tw is None) == (S == R)
        if tw is not None:
            qk = np.arange(R)[:, None] * np.arange(S // R)[None, :]
            assert np.abs(tw.numpy() - np.exp(-2j * np.pi * qk / S)).max() \
                <= 5e-7, (L, S)
    e = np.arange(L)
    fine = torch.as_tensor(tab[slots].astype(np.complex64))
    got = (czt.twiddle_table(L, "cpu")[64 + (e >> 6)] * fine[e & 63]).numpy()
    assert np.abs(got - np.exp(-2j * np.pi * e / L)).max() <= 2.5e-7
    # the spectrum of e^{−2πi·n·k/L}·… : X = L·δ[bin k]; its digit-reversed
    # position is where digit_reversed(arange) holds k
    pos = czt.digit_reversed(torch.arange(L))
    assert sorted(pos.tolist()) == list(range(L))
    # filter_table: the same order, pairs of a lane's 16 points laid out so
    # that 32 lanes' loads of one pair are contiguous
    hf = czt.filter_table(torch.arange(L))
    g, k = np.meshgrid(np.arange(L // 16), np.arange(8), indexing="ij")
    at = 2 * (256 * (g // 32) + 32 * k + g % 32)
    assert torch.equal(hf[at], pos[16 * g + 2 * k])
    assert torch.equal(hf[at + 1], pos[16 * g + 2 * k + 1])
    for k in (0, 1, 3, 17, L // 3 + 5, L - 1):
        p = int((pos == k).nonzero())
        x = torch.as_tensor(np.exp(2j * np.pi * k * np.arange(L) / L)
                            .astype(np.complex64))[None]
        for R, S, W, tw in czt._fused_stages(L, "cpu"):
            b = torch.einsum("nbjq,jk->nbkq", x.view(1, L // S, R, S // R), W)
            x = (b if tw is None else b * tw).reshape(1, L)
        assert int(x.abs().argmax()) == p, (L, k)


@pytest.mark.parametrize("n_fft", CZT_BANDS)
def test_chirp_tables_are_their_closed_forms(n_fft):
    """The pre-chirp e^{−iα(n·k_lo + n²/2)}, the post-chirp e^{−iα·m²/2}
    and H, the L-point spectrum of e^{+iα·j²/2} over j = −(N−1) … M−1
    laid circularly, over L·ofdm_scale, α = 2π(1+δ)/N: each within
    complex64's rounding of its float64 closed form, at δ = 1.5e-4 and
    −9e-4; L the least 2^a or 3·2^a that holds the convolution."""
    from gf3x_torch import GF3_STANDARD as T_STANDARD

    cfg = T_STANDARD.replace(**WARPED_BANDS[n_fft])
    N, M, k_lo = cfg.n_fft, cfg.n_used, cfg.bin_lo
    L = tofdm.czt_length(cfg)
    assert L == min(c for a in range(40) for c in (1 << a, 3 << a)
                    if c >= N + M - 1)
    for delta in map(np.float32, (1.5e-4, -9e-4)):
        pre, post, H = tofdm.chirp_tables(cfg, torch.tensor(delta), "cpu", L)
        assert (pre.dtype, post.dtype, H.dtype) == (torch.complex64,) * 3
        alpha = 2 * np.pi * (1.0 + float(delta)) / N
        n, m = np.arange(N, dtype=np.float64), np.arange(M, dtype=np.float64)
        i = np.arange(L)
        j = np.where(i < M, i, i - L).astype(np.float64)
        h = np.where(j > -N, np.exp(0.5j * alpha * j * j), 0.0)
        want_H = np.fft.fft(h) / (L * cfg.ofdm_scale)
        for got, want in ((pre, np.exp(-1j * alpha * (n * k_lo + n * n / 2))),
                          (post, np.exp(-0.5j * alpha * m * m)),
                          (H, want_H)):
            err = np.abs(got.numpy().astype(np.complex128) - want)
            assert np.all(err <= 1.2e-7 * np.abs(want)
                          + 1e-12 * np.abs(want).max()), (n_fft, delta)


@pytest.mark.parametrize("n_fft", sorted(WARPED_BANDS))
def test_czt_rows_are_counted(n_fft):
    """`ofdm.czt_rows` counts the symbol rows the chirp-z transform takes:
    every warped row at a wide band, none at config 5 (gf3x's dense
    product) and none of an unwarped DFT; `ofdm.czt_fused_rows` those of
    them its fused kernel takes: all of them at the three wide bands."""
    from gf3x_torch import GF3_STANDARD as T_STANDARD
    from gf3x_torch.utils import profiling

    cfg = T_STANDARD.replace(**WARPED_BANDS[n_fft])
    sym = torch.zeros(3, 2, n_fft)
    profiling.reset()
    try:
        with profiling.recording():
            tofdm.ofdm_dft(cfg, sym, torch.tensor(1e-4))
            tofdm.ofdm_dft(cfg, sym)
        c = profiling.counters()
    finally:
        profiling.reset()
    assert (c["ofdm.warped_dfts"], c["ofdm.warped_rows"]) == (1, 6)
    assert c["ofdm.czt_rows"] == (6 if n_fft > 1024 else 0)
    assert c["ofdm.czt_fused_rows"] == c["ofdm.czt_rows"]


def _known_rx(rng, B=3):
    """Known symbols through a 3-tap channel with a bulk delay + noise."""
    from gf3x.config import layout

    X = layout(CFG).known_syms
    k = np.arange(CFG.bin_lo, CFG.bin_hi + 1)
    H = np.zeros((B, CFG.n_used), np.complex128)
    for b in range(B):
        taps = rng.standard_normal(3) + 1j * rng.standard_normal(3)
        delays = np.array([5, 9, 30]) + 7 * b
        H[b] = (taps[:, None]
                * np.exp(-2j * np.pi * np.outer(delays, k) / CFG.n_fft)).sum(0)
    Y = H[:, None, :] * X + 0.05 * crandn(rng, B, *X.shape)
    return Y.astype(np.complex64)


def test_estimate_channel_with_isi_matches():
    """LS estimate + tap denoise + ISI profile: ≤ 1e-4 rel (float32 complex
    matmuls through 280×280 tables). Ĥ and noise_var against gf3x; the ISI
    profile against gf3x on the row whose anchor stays (at gf3x's scale
    over all rows), and on every row against its plain float64 copy
    (tests/isi_plain.py): the taps at 5 and 9 arrive before gf3x's anchor
    ŝ − 16 on two rows, which the port's anchor moves ahead of."""
    Y = _known_rx(np.random.default_rng(6))
    H_r, nv_r, (iv_r, ir_r) = jchan.estimate_channel(CFG, jnp.asarray(Y),
                                                     with_isi=True)
    H_t, nv_t, (iv_t, ir_t) = tchan.estimate_channel(CFG, torch.as_tensor(Y),
                                                     with_isi=True)
    raw = isi_plain.raw_estimate(CFG, Y)
    iv_p, ir_p = isi_plain.isi_profile(CFG, *raw)
    keep = isi_plain.stays(CFG, *raw)
    assert keep.sum() == 1
    assert rel(H_t.numpy(), H_r) <= 1e-4
    assert rel(nv_t.numpy(), nv_r) <= 1e-4
    for got, ref in ((iv_t, iv_r), (ir_t, ir_r)):
        ref = np.asarray(ref)
        assert (np.max(np.abs(got.numpy()[keep] - ref[keep]))
                <= 1e-4 * np.max(np.abs(ref)))
    assert rel(iv_t.numpy(), iv_p) <= 1e-4
    assert rel(ir_t.numpy(), ir_p) <= 1e-4


def test_host_tables_equal():
    """Denoise projector and ISI operator: the same float64 host code, so
    bit-exact."""
    assert np.array_equal(tchan.denoise_projection(CFG),
                          jchan.denoise_projection(CFG))
    for a, b in zip(tchan._isi_operator(CFG), jchan._isi_operator(CFG)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_pilot_phase_correct_matches():
    """CSI-weighted slope/CPE fit and derotation on equalized symbols with a
    planted phase ramp: slope and cpe ≤ 1e-4 rad abs, bins ≤ 1e-4 rel."""
    from gf3x.config import layout

    rng = np.random.default_rng(7)
    D = CFG.n_data_symbols
    lay = layout(CFG)
    X = crandn(rng, 2, D, CFG.n_used) / np.sqrt(2)
    X[..., lay.pilot_pos] = lay.pilot_vals
    kk = np.arange(CFG.n_used)
    a = rng.uniform(-0.02, 0.02, (2, D, 1))
    b = rng.uniform(-1, 1, (2, D, 1))
    eq = (X * np.exp(1j * (a * kk + b))
          + 0.03 * crandn(rng, 2, D, CFG.n_used)).astype(np.complex64)
    H = (1.0 + 0.3 * crandn(rng, 2, CFG.n_used)).astype(np.complex64)
    e_r, s_r, c_r = jchan.pilot_phase_correct(CFG, jnp.asarray(eq),
                                              jnp.asarray(H))
    e_t, s_t, c_t = tchan.pilot_phase_correct(CFG, torch.as_tensor(eq),
                                              torch.as_tensor(H))
    assert np.max(np.abs(s_t.numpy() - np.asarray(s_r))) <= 1e-4
    assert np.max(np.abs(c_t.numpy() - np.asarray(c_r))) <= 1e-4
    assert rel(e_t.numpy(), e_r) <= 1e-4
    assert np.allclose(s_t.numpy(), a[..., 0], atol=2e-3)   # and it tracks


def _chirp_batch(rng, delays, T):
    c = make_chirp(CFG).astype(np.float32)
    rx = 0.05 * rng.standard_normal((len(delays), T)).astype(np.float32)
    for i, d in enumerate(delays):
        rx[i, d: d + len(c)] += c
        rx[i, d + 40: d + 40 + len(c)] += 0.4 * c          # an echo
    return rx


@pytest.mark.parametrize("bounded", [True, False])
def test_find_frame_start_matches(bounded):
    """Chirp sync: bounded 2×-decimated and unbounded searches agree with
    gf3x within the decimation step (2 samples) and land inside the CP
    backoff (cp // 4) of the planted onset. Metric ≤ 1e-3 rel."""
    rng = np.random.default_rng(8 + bounded)
    delays = [0, 37, 1999, 3001]
    T = CFG.chirp_len + 4400
    rx = _chirp_batch(rng, delays, T)
    kw = dict(search_len=4352, decimate=2) if bounded else {}
    s_r, m_r = jsync.find_frame_start(CFG, jnp.asarray(rx), make_chirp(CFG),
                                      **kw)
    s_t, m_t = tsync.find_frame_start(CFG, torch.as_tensor(rx),
                                      make_chirp(CFG), **kw)
    assert s_t.dtype == torch.int32
    assert np.max(np.abs(s_t.numpy() - np.asarray(s_r))) <= 2
    assert np.max(np.abs(s_t.numpy() - np.asarray(delays))) <= CFG.cp // 4
    assert rel(m_t.numpy(), m_r) <= 1e-3
    assert tsync.bounded_sync_nfft(T, 4352, CFG.chirp_len, 2) == \
        jsync.bounded_sync_nfft(T, 4352, CFG.chirp_len, 2)


GEOM = dict(S=5, n_fft=512, sym_len=640, cp=128, body_off=640, sc_off=96,
            block=128)


def test_cut_symbols_matches_gf3x_cut():
    """Frame cut on a ragged recording (T % block ≠ 0) at random starts
    plus both clamp edges: symbols, SC window and roll exactly equal to
    gf3x's `cut_symbols` (its CPU route: gather_cut + reshape/slice)."""
    rng = np.random.default_rng(9)
    T, B = 9000 + 77, 16
    rx = rng.standard_normal((B, T)).astype(np.float32)
    starts = rng.integers(0, T - 640 - 5 * 640 - 200, B).astype(np.int32)
    starts[:2] = [0, T]                       # clamp edges (zero tail)
    r_syms, r_scw, r_roll = jsync.cut_symbols(jnp.asarray(rx),
                                              jnp.asarray(starts), **GEOM)
    t_syms, t_scw, t_roll = tsync.cut_symbols(torch.as_tensor(rx),
                                              torch.as_tensor(starts), **GEOM)
    assert np.array_equal(t_syms.numpy(), np.asarray(r_syms))
    assert np.array_equal(t_scw.numpy(), np.asarray(r_scw))
    assert np.array_equal(t_roll.numpy(), np.asarray(r_roll))


def test_cut_symbols_matches_pallas_interpret():
    """The same cut against the TPU kernel itself (Pallas interpret mode,
    whole-prefix staging): exactly equal."""
    from gf3x.ops.pallas.gather_cut import cut_symbols_tpu

    rng = np.random.default_rng(10)
    T, B, block = 9000 + 77, 16, 128
    rx = rng.standard_normal((B, T)).astype(np.float32)
    starts = rng.integers(0, T - 640 - 5 * 640 - 200, B).astype(np.int32)
    need = 640 + 5 * 640
    nb = -(-(-(-(need + block) // block)) // 8) * 8
    nf = T // block
    q = np.clip(starts // block, 0, nf + 8 - nb).astype(np.int32)
    g = {k: v for k, v in GEOM.items() if k != "block"}
    p_syms, p_scw = cut_symbols_tpu(
        jnp.asarray(rx), jnp.asarray(q), jnp.zeros(B // 8, jnp.int32), block,
        g["S"], g["n_fft"], g["body_off"], g["sym_len"], g["cp"],
        g["sc_off"], 8, nf, True)
    t_syms, t_scw, _ = tsync.cut_symbols(torch.as_tensor(rx),
                                         torch.as_tensor(starts), **GEOM)
    assert np.array_equal(t_syms.numpy(), np.asarray(p_syms))
    assert np.array_equal(t_scw.numpy(), np.asarray(p_scw))


def test_cut_symbols_short_recording_matches():
    """A recording shorter than one window (degenerate route): the whole
    recording zero-extended from block 0, as gf3x cuts it."""
    rng = np.random.default_rng(11)
    rx = rng.standard_normal((3, 2000)).astype(np.float32)
    starts = np.array([0, 50, 900], np.int32)
    r = jsync.cut_symbols(jnp.asarray(rx), jnp.asarray(starts), **GEOM)
    t = tsync.cut_symbols(torch.as_tensor(rx), torch.as_tensor(starts), **GEOM)
    for a, b in zip(t, r):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_sc_metric_and_clock_offset_match():
    """SC window metric and the pilot-slope clock estimate: ≤ 1e-5 rel."""
    rng = np.random.default_rng(12)
    win = rng.standard_normal((4, CFG.n_fft)).astype(np.float32)
    win[1, CFG.n_fft // 2:] = win[1, : CFG.n_fft // 2]      # repeated halves
    ref = np.asarray(jsync.sc_metric_window(CFG, jnp.asarray(win)))
    got = tsync.sc_metric_window(CFG, torch.as_tensor(win)).numpy()
    assert rel(got, ref) <= 1e-5 and got[1] > 0.99
    from gf3x.ops.sfo import slope_clock_offset as j_sco

    slopes = rng.normal(0, 1e-3, (4, CFG.n_data_symbols)).astype(np.float32)
    assert rel(slope_clock_offset(CFG, torch.as_tensor(slopes)).numpy(),
               j_sco(CFG, jnp.asarray(slopes))) <= 1e-5
