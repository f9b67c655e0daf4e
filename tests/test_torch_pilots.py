"""Every pilot layout on the port against gf3x, on the CPU: gf3x's
degenerate corners (tests/test_property_configs.py's CORNERS — pilotless,
one pilot, two, loaded pilotless, ...), the 93-bin layout of
tests/test_ber_sweep.py and tests/test_parallel.py (spacing 8 does not
tile 93 bins) and an offset grid (pilot_offset = 3).

The layouts the port's tail kernels take from their tables since they stop
assuming a strided grid of two or more pilots (`NEW`) are held to gf3x's
Modem, bit for bit; the others, which the port ran before, to gf3x's
GoldenModem (NumPy), which needs no compile. The tail's plain versions —
kernels 2, A and B — are held to gf3x's XLA tail (`_eq_tail`,
`_xla_demap`) on the same spectra, and kernel 2's layout table to the
config's layout. The CUDA kernels run only on the card: `chip_smoke.py`'s
"pilots" phase holds them against these plain versions there."""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gf3x import GoldenModem as JGolden
from gf3x import Modem as JModem
from gf3x import ModemConfig as JConfig
from gf3x.ops.chanest import estimate_channel as j_estimate
from gf3x.ops.ofdm import ofdm_demodulate

from gf3x_torch import Modem, ModemConfig, layout
from gf3x_torch.channel import awgn, delay_gain
from gf3x_torch.models import frame as tframe
from gf3x_torch.models.stream import frame_capacity
from gf3x_torch.ops.kernels import eq_layout, fused_eq, split_eq
from gf3x_torch.utils import device

from test_property_configs import CORNERS

LAYOUTS = dict(CORNERS,
               bins93=dict(n_fft=256, cp=64, bin_lo=8, bin_hi=100,
                           pilot_spacing=8, n_known_symbols=2,
                           n_data_symbols=12, chirp_duration=0.02),
               offset3=dict(pilot_offset=3))
NEW = ("pilotless", "one_pilot", "pilotless_tiny_cp_k1", "loaded_pilotless",
       "bins93", "offset3")


def configs(name, **over):
    """The layout's port and gf3x configs (fec='none' unless `over`)."""
    kw = dict(fec="none", **LAYOUTS[name])
    kw.update(over)
    return ModemConfig(**kw).validate(), JConfig(**kw).validate()


def test_new_layouts_are_the_ones_off_the_strided_grid():
    """`NEW` is every layout here that is not a strided grid of two or more
    pilots — what the kernels refused before they took tables."""
    off = {name for name in LAYOUTS
           if not (configs(name)[0].strided_pilots
                   and configs(name)[0].n_pilots >= 2)}
    assert off == set(NEW)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_loopback_matches_gf3x(name):
    """Encode → clean loopback at the known onset (the corner test's
    drive), on the port's Modem(device='cpu'): the payload back with CRC,
    finite LLR scale, the transmit waveform within 1e-5 of the reference's
    peak, and the decoded bits equal to the reference's — gf3x's Modem on
    the NEW layouts, its GoldenModem on the rest. On the NEW layouts also a
    delayed, 30 dB recording through the chirp sync, bits equal to gf3x's
    Modem on the same samples."""
    cfg, jcfg = configs(name)
    m = Modem(cfg, device="cpu")
    ref = JModem(jcfg) if name in NEW else JGolden(jcfg)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    payload = bytes(rng.integers(0, 256, min(frame_capacity(m), 64),
                                 dtype=np.uint8))
    wav, wav_r = m.encode(payload), np.asarray(ref.encode(payload))
    assert np.max(np.abs(wav - wav_r)) <= 1e-5 * np.max(np.abs(wav_r))
    res = m.decode(wav, start=0)
    rres = ref.decode(wav.astype(np.float32 if name in NEW else np.float64),
                      start=0)
    assert res.crc_ok and res.payload == payload, cfg
    assert rres.crc_ok and np.array_equal(res.bits, rres.bits), cfg
    assert np.all(np.isfinite(res.diag.mean_abs_llr)), cfg
    if name not in NEW:
        return
    rx = awgn(delay_gain(wav.astype(np.float64), 300, 0.7,
                         total_len=len(wav) + 2000), 30.0, rng)
    res, rres = m.decode(rx), ref.decode(rx.astype(np.float32))
    assert res.crc_ok and res.payload == payload, cfg
    assert np.array_equal(res.bits, rres.bits), cfg
    assert abs(int(res.diag.sync_start) - int(rres.diag.sync_start)) \
        <= m._sync_decimate


def tail_inputs(cfg, jcfg, B=3, sigma=3e-3, seed=0):
    """gf3x's spectra, LS estimate and noise floor (NumPy) of B random
    frames from the port's transmitter, cut at the prewindowed body, with
    AWGN."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, cfg.payload_bits_per_frame), dtype=np.uint8)
    wav = Modem(cfg, device="cpu").modulate_frames(
        torch.as_tensor(info)).numpy()
    a = cfg.preamble_len - cfg.cp // 4
    need = (cfg.n_known_symbols + cfg.n_data_symbols) * cfg.symbol_len
    body = (wav[:, a: a + need]
            + rng.normal(0, sigma, (B, need))).astype(np.float32)
    Y = ofdm_demodulate(jcfg, jnp.asarray(body))
    H, nv = j_estimate(jcfg, Y[..., : jcfg.n_known_symbols, :])
    return np.asarray(Y), np.asarray(H), np.asarray(nv)


@pytest.mark.parametrize("name", NEW + ("two_pilots",))
def test_tail_plain_versions_match_gf3x_xla(name):
    """Kernels 2, A and B's plain versions against gf3x's XLA tail
    (`_eq_tail`, then `_xla_demap`) on the same spectra, per the tolerances
    of ROADMAP §3: hard decisions exact, LLRs ≤ 2e-4·mean|LLR|, slope and
    cpe ≤ 1e-4 rad, evm, mean|llr| and the effective noise ≤ 1e-4 relative.
    Below two pilots slope and cpe are 0; without pilots nv_sym is the LS
    noise variance. A uniform config runs both tails (kernel 2's, and A +
    B), a bit-loaded one the split."""
    cfg, jcfg = configs(name, n_data_symbols=4)
    Y, H, nv = tail_inputs(cfg, jcfg)
    jm = JModem(jcfg)
    data_r, nveff_r, (slope_r, cpe_r) = jax.tree.map(
        np.asarray, jm._eq_tail(jnp.asarray(Y), jnp.asarray(H),
                                jnp.asarray(nv)))
    llr_r, evm_r, mabs_r, _ = (np.asarray(x) for x in jm._xla_demap(
        jnp.asarray(data_r), jnp.asarray(nveff_r), (Y.shape[0],)))
    Yt, Ht, nvt = (torch.as_tensor(x.copy()) for x in (Y, H, nv))

    eq, slope, cpe, nv_sym = split_eq.eq_track_plain(cfg, Yt, Ht, nvt)
    _, data = tframe.split_pilots(cfg, eq)
    _, inv_csi = tframe.split_pilots(cfg, 1.0 / torch.clamp(Ht.abs() ** 2,
                                                            min=1e-12))
    nveff = (nv_sym[..., None] * inv_csi[:, None, :]).numpy()

    def rel(a, b):
        return np.max(np.abs(a - b)) / np.mean(np.abs(b))

    assert rel(data.numpy(), data_r) <= 1e-4
    assert rel(nveff, np.broadcast_to(nveff_r, nveff.shape)) <= 1e-4
    if cfg.n_pilots == 0:
        assert torch.equal(nv_sym, nvt[:, None].expand_as(nv_sym))
    if cfg.n_pilots < 2:
        assert not slope.any() and not cpe.any()
    tables = tuple(torch.as_tensor(t) for t in tframe.demap_bin_tables(cfg))
    tails = [(*split_eq.demap_bins(cfg, eq, Ht, nv_sym, tables)[:1], slope,
              cpe, *split_eq.demap_bins(cfg, eq, Ht, nv_sym, tables)[1:])]
    if cfg.bit_loading is None:
        tails.append(fused_eq.fused_eq_demap_plain(cfg, Yt, Ht, nvt))
    for llr, sl, cp, evm, mabs in tails:
        llr = llr.numpy()
        assert llr.shape == llr_r.shape
        assert np.array_equal(llr < 0, llr_r < 0)
        assert np.max(np.abs(llr - llr_r)) <= 2e-4 * np.mean(np.abs(llr_r))
        assert np.max(np.abs(sl.numpy() - slope_r)) <= 1e-4
        assert np.max(np.abs(cp.numpy() - cpe_r)) <= 1e-4
        assert np.allclose(evm.numpy(), evm_r, rtol=1e-4)
        assert np.allclose(mabs.numpy(), mabs_r, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_kernel_layout_table_is_the_layout(name):
    """Kernel 2's layout table (`split_eq.layout_table`): the P pilot
    positions, then the data positions. A CPU emulation of the kernel's
    walk — lane l reads the bins of table entries P + l, P + l + 32, ... —
    cuts the data bins `split_pilots` cuts, and on a strided layout the
    table holds what the arithmetic walk computed (p·sp; data bin j at
    j + j // (sp − 1) + 1), so the kernels' strided results are unchanged.
    Kernel A reads the first P entries, kernel B the data positions through
    `demap_bin_tables`."""
    cfg, _ = configs(name)
    lay, P, nd = layout(cfg), cfg.n_pilots, cfg.n_data_bins
    table = split_eq.layout_table(cfg, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (cfg.n_used,)
    assert np.array_equal(table[:P].numpy(), lay.pilot_pos)
    assert np.array_equal(table[P:].numpy(), lay.data_pos)
    bins = torch.randn(2, cfg.n_used, dtype=torch.complex64,
                       generator=torch.Generator().manual_seed(1))
    walk = torch.empty(2, nd, dtype=torch.complex64)
    for lane in range(32):
        for j in range(lane, nd, 32):
            walk[:, j] = bins[:, int(table[P + j])]
    pil, data = tframe.split_pilots(cfg, bins)
    assert torch.equal(walk, data)
    assert torch.equal(pil, bins[:, table[:P].long()])
    assert np.array_equal(tframe.demap_bin_tables(cfg)[0], lay.data_pos)
    if cfg.strided_pilots:
        sp, j = cfg.pilot_spacing, np.arange(nd)
        assert np.array_equal(table[:P].numpy(), np.arange(P) * sp)
        assert np.array_equal(table[P:].numpy(), j + j // (sp - 1) + 1)


@pytest.mark.parametrize("name", NEW)
def test_interleave_pilots_inverts_split(name):
    """On every irregular or degenerate layout the index scatter and gather
    invert each other, and put the config's pilot values at its pilot
    positions, as gf3x's `interleave_pilots` does."""
    cfg, _ = configs(name)
    lay = layout(cfg)
    g = torch.Generator().manual_seed(2)
    data = torch.randn(3, 2, cfg.n_data_bins, dtype=torch.complex64,
                       generator=g)
    bins = tframe.interleave_pilots(cfg, data)
    assert bins.shape == (3, 2, cfg.n_used)
    pil, back = tframe.split_pilots(cfg, bins)
    assert torch.equal(back, data)
    assert torch.equal(pil, torch.as_tensor(lay.pilot_vals).expand_as(pil))
    assert torch.equal(bins[..., torch.as_tensor(lay.data_pos).long()], data)


def test_launch_constants_below_two_pilots_have_no_fit():
    """Kernel 2's constants for P < 2 carry no ladder and a finite mean
    spacing (np.mean(np.diff([])) would be NaN), and the geometry fits."""
    for name in ("pilotless", "one_pilot"):
        cfg, _ = configs(name)
        (mean_dk, n_ladder, *_), *_ = fused_eq.launch_constants(cfg)
        assert n_ladder == 0 and np.isfinite(mean_dk)
        for demap in (True, False):
            geo = eq_layout.fused_eq_geometry(cfg, 1024, demap=demap)
            assert 0 < geo.smem <= device.SMEM_BLOCK
