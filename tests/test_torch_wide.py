"""The wide bands — GF3's band (1.03-13.1 kHz) with the symbol lengthened
for long reverb, CP = N/4, as `chip_smoke.WIDE_BANDS` defines them:
gf3-4096 (U = 1120), gf3-8192 (U = 2240, 64-QAM) and gf3-16384 (U = 7616,
pilot spacing 4, 64-QAM) — on the port against gf3x on the CPU, cut to
D = 4 data symbols and B = 8 rows (whole 8-row groups: the batched cut).

Tolerances (tests/test_torch_long_cp.py's): payload bits exact and CRC ok;
sync_start within the decimation step (2); H, noise_var, isi_var ≤ 1e-3
rel; slope/cpe ≤ 1e-4 rad; evm, mean|LLR| and sc_metric ≤ 1e-3 rel;
fec_unsat exact; the LLR histograms' totals exact and their bins within 4
counts. The tail's plain versions (kernels 2, A and B) against gf3x's XLA
tail: hard decisions exact, LLRs ≤ 2e-4·mean|LLR|, slope/cpe ≤ 1e-4 rad,
the rest ≤ 1e-4 rel (tests/test_torch_pilots.py's).

The CUDA kernels run only on the card: `chip_smoke.py`'s "wide" phase
holds them, in every layout, against these plain versions there. Here:
their launch geometry (kernels 2 and A teamed, kernel B staged where a
warp count fits, else streamed), kernel B's slot table past 2¹⁴ bins,
and kernel 8's route."""

from collections import Counter

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gf3x import GF3_STANDARD as J_STANDARD
from gf3x import Modem as JModem

import chip_smoke
from gf3x_torch import GF3_STANDARD, Modem
from gf3x_torch.models import frame as tframe
from gf3x_torch.ops.kernels import (cut_dft, eq_layout, fused_eq, gather_cut,
                                    split_eq)
from gf3x_torch.utils import device

from test_torch_long_cp import build_batch, counting
from test_torch_pilots import tail_inputs

WIDE = {name: GF3_STANDARD.replace(**kw)
        for name, kw in chip_smoke.WIDE_BANDS.items()}
MARGIN = 4096
# the same bands with a CP whose cut gf3x's fused kernels take (every
# offset on the 128 grid): kernel 8's route turns on n_fft alone there
ALIGNED = {"gf3-4096": dict(chip_smoke.WIDE_BANDS["gf3-4096"], cp=768),
           "gf3-8192": dict(chip_smoke.WIDE_BANDS["gf3-8192"], cp=1792)}


def loaded(cfg):
    """The band bit-loaded with chip_smoke's table over its data bins."""
    return cfg.replace(bit_loading=chip_smoke.loading_table(cfg.n_data_bins))


@pytest.fixture(scope="module", params=["gf3-4096", "gf3-8192"])
def batch(request):
    """B = 8 recordings of one band at D = 4, decoded once by gf3x (bounded
    sync, `_decode_jit`)."""
    kw = dict(chip_smoke.WIDE_BANDS[request.param], n_data_symbols=4)
    jm = JModem(J_STANDARD.replace(**kw), max_delay=MARGIN + kw["cp"])
    rx, payload = build_batch(jm, 8, np.random.default_rng(0))
    bits, diag = jm._decode_jit(jnp.asarray(rx))
    cfg = GF3_STANDARD.replace(**kw)
    return cfg, rx, payload, np.asarray(bits), jax.device_get(diag)


def test_wide_demodulate_matches_gf3x(batch, monkeypatch):
    """`demodulate` of the band on B = 8: the cut is kernel 6's (gf3x's
    fused cut refuses the SC window offset, cp + cp/4 + 64, off the 128
    grid), and bits and diagnostics equal gf3x's within the stated
    tolerances."""
    cfg, rx, payload, j_bits, jd = batch
    tm = Modem(cfg, max_delay=MARGIN + cfg.cp, device="cpu")
    assert tm._fused_cut_refuses(rx.shape[-1])
    called = counting(monkeypatch, gather_cut,
                      ("gather_cut", "gather_cut_group", "cut_symbols"))
    bits, d = tm.demodulate(torch.as_tensor(rx))
    assert called == ["gather_cut_group"]
    assert np.array_equal(bits.numpy(), j_bits)
    for b in bits.numpy():
        res = tm._result(b, None)
        assert res.crc_ok and res.payload == payload
    assert np.max(np.abs(d.sync_start.numpy()
                         - np.asarray(jd.sync_start))) <= 2

    def rel(a, b):
        return np.max(np.abs(a - b)) / np.max(np.abs(b))

    Hj = np.asarray(jd.H)[..., 0] + 1j * np.asarray(jd.H)[..., 1]
    assert rel(d.H.numpy(), Hj) <= 1e-3
    assert rel(d.noise_var.numpy(), np.asarray(jd.noise_var)) <= 1e-3
    assert rel(d.isi_var.numpy(), np.asarray(jd.isi_var)) <= 1e-3
    assert np.max(np.abs(d.pilot_slope.numpy()
                         - np.asarray(jd.pilot_slope))) <= 1e-4
    assert np.max(np.abs(d.common_phase.numpy()
                         - np.asarray(jd.common_phase))) <= 1e-4
    for name in ("evm", "mean_abs_llr", "sc_metric"):
        assert np.allclose(getattr(d, name).numpy(),
                           np.asarray(getattr(jd, name)), rtol=1e-3), name
    assert np.array_equal(d.fec_unsat.numpy(), np.asarray(jd.fec_unsat))
    assert not d.fec_unsat.numpy().any()
    assert np.array_equal(d.llr_hist.numpy().sum(-1),
                          np.asarray(jd.llr_hist).sum(-1))
    assert np.abs(d.llr_hist.numpy() - np.asarray(jd.llr_hist)).sum() <= 4


def test_wide_use_cut_dft_takes_the_two_stage_cut(batch, monkeypatch):
    """With `use_cut_dft=True` the band's plain decode yields to the
    two-stage cut, as gf3x's `cut_dft_spectra` does: kernel 6 cuts, kernel
    8 never runs, and the bits equal gf3x's."""
    cfg, rx, _, j_bits, _ = batch
    tm = Modem(cfg, max_delay=MARGIN + cfg.cp, device="cpu",
               use_cut_dft=True)
    assert not tm._takes_cut_dft(rx.shape[-1])
    called = counting(monkeypatch, gather_cut, ("gather_cut_group",))
    dft = counting(monkeypatch, cut_dft, ("cut_dft",))
    bits, _ = tm.demodulate(torch.as_tensor(rx))
    assert called == ["gather_cut_group"] and dft == []
    assert np.array_equal(bits.numpy(), j_bits)


@pytest.mark.parametrize("name", sorted(ALIGNED))
def test_use_cut_dft_route_turns_on_kernel_8s_n_fft(name, monkeypatch):
    """On a cut gf3x's fused kernels take, `use_cut_dft` takes kernel 8 at
    n_fft = 4096 and declines it at 8192 (kernel 8's FFT takes n_fft up to
    4096; gf3x's declines by its VMEM budget): there the cut is kernel 1's
    and `cut_dft.cut_dft` is never called. Either way the bits equal the
    two-stage decode's, with every row CRC-ok."""
    cfg = GF3_STANDARD.replace(n_data_symbols=4, **ALIGNED[name])
    rx, payload = build_batch(Modem(cfg, device="cpu"), 8,
                              np.random.default_rng(1))
    T = rx.shape[-1]
    tm = Modem(cfg, max_delay=MARGIN + cfg.cp, device="cpu",
               use_cut_dft=True)
    assert not tm._fused_cut_refuses(T)
    takes = cfg.n_fft <= 4096
    assert tm._takes_cut_dft(T) == takes == cut_dft.takes(cfg)
    cut = counting(monkeypatch, gather_cut, ("cut_symbols",
                                             "gather_cut_group"))
    dft = counting(monkeypatch, cut_dft, ("cut_dft",))
    bits, _ = tm.demodulate(torch.as_tensor(rx))
    assert dft == (["cut_dft"] if takes else [])
    assert cut == ([] if takes else ["cut_symbols"])
    two_stage, _ = Modem(cfg, max_delay=MARGIN + cfg.cp,
                         device="cpu").demodulate(torch.as_tensor(rx))
    assert torch.equal(bits, two_stage)
    for b in bits.numpy():
        res = tm._result(b, None)
        assert res.crc_ok and res.payload == payload


# gf3-16384's tail is held on the card only: a Modem at U = 7616 builds
# its U × U float64 host tables (the ISI operator's solve) for ~50 s here
TAILS = {"gf3-4096": WIDE["gf3-4096"], "gf3-8192": WIDE["gf3-8192"],
         "gf3-8192 loaded": loaded(WIDE["gf3-8192"])}


@pytest.mark.parametrize("name", list(TAILS))
def test_wide_tail_plain_versions_match_gf3x_xla(name):
    """Kernels 2, A and B's plain versions at U = 1120 and 2240 against gf3x's XLA tail (`_eq_tail`, then `_xla_demap`) on the same
    spectra: hard decisions exact, LLRs ≤ 2e-4·mean|LLR|, slope and cpe
    ≤ 1e-4 rad, evm, mean|llr| and the effective noise ≤ 1e-4 rel. A
    uniform band runs both tails (kernel 2's and A + B), a loaded one the
    split."""
    cfg = TAILS[name].replace(n_data_symbols=4, fec="none")
    jcfg = J_STANDARD.replace(**{k: getattr(cfg, k) for k in (
        "n_fft", "cp", "bin_lo", "bin_hi", "pilot_spacing", "bits_per_symbol",
        "bit_loading", "n_data_symbols", "fec")})
    Y, H, nv = tail_inputs(cfg, jcfg, B=2)
    jm = JModem(jcfg)
    data_r, nveff_r, (slope_r, cpe_r) = jax.tree.map(
        np.asarray, jm._eq_tail(jnp.asarray(Y), jnp.asarray(H),
                                jnp.asarray(nv)))
    llr_r, evm_r, mabs_r, _ = (np.asarray(x) for x in jm._xla_demap(
        jnp.asarray(data_r), jnp.asarray(nveff_r), (Y.shape[0],)))
    Yt, Ht, nvt = (torch.as_tensor(x.copy()) for x in (Y, H, nv))

    eq, slope, cpe, nv_sym = split_eq.eq_track(cfg, Yt, Ht, nvt)
    _, data = tframe.split_pilots(cfg, eq)
    _, inv_csi = tframe.split_pilots(cfg, 1.0 / torch.clamp(Ht.abs() ** 2,
                                                            min=1e-12))
    nveff = (nv_sym[..., None] * inv_csi[:, None, :]).numpy()
    assert np.max(np.abs(data.numpy() - data_r)) \
        <= 1e-4 * np.mean(np.abs(data_r))
    assert np.max(np.abs(nveff - nveff_r)) <= 1e-4 * np.mean(np.abs(nveff_r))
    tables = tuple(torch.as_tensor(t) for t in tframe.demap_bin_tables(cfg))
    llr, evm, mabs = split_eq.demap_bins(cfg, eq, Ht, nv_sym, tables)
    tails = [(llr, slope, cpe, evm, mabs)]
    if cfg.bit_loading is None:
        tails.append(fused_eq.fused_eq_demap(cfg, Yt, Ht, nvt))
    for llr, sl, cp, evm, mabs in tails:
        llr = llr.numpy()
        assert llr.shape == llr_r.shape
        assert np.array_equal(llr < 0, llr_r < 0)
        assert np.max(np.abs(llr - llr_r)) <= 2e-4 * np.mean(np.abs(llr_r))
        assert np.max(np.abs(sl.numpy() - slope_r)) <= 1e-4
        assert np.max(np.abs(cp.numpy() - cpe_r)) <= 1e-4
        assert np.allclose(evm.numpy(), evm_r, rtol=1e-4)
        assert np.allclose(mabs.numpy(), mabs_r, rtol=1e-4)


def synthetic_tables(n_bins: int, seed: int = 3):
    """Per-data-bin tables (used-bin index, bits, wire offset) of n_bins
    data bins at used bins 0..n_bins−1, loaded 0/2/4/6 at random and
    group-sorted on the wire as `demap_bin_tables` orders them."""
    rng = np.random.default_rng(seed)
    bits = rng.choice([0, 2, 4, 6], size=n_bins)
    bits[-1] = 6
    order = np.lexsort((np.arange(n_bins), bits))
    off = np.zeros(n_bins, dtype=np.int64)
    off[order] = np.concatenate([[0], np.cumsum(bits[order])[:-1]])
    return np.arange(n_bins), bits, off


SLOTS = {"U = 16383": synthetic_tables(16383),
         "gf3-16384 loaded": tframe.demap_bin_tables(
             loaded(WIDE["gf3-16384"])),
         "gf3-16384": tframe.demap_bin_tables(WIDE["gf3-16384"])}


@pytest.mark.parametrize("name", list(SLOTS))
def test_slot_table_round_trips_wide_bins(name):
    """Kernel B's two-word slots give back every active bin's used-bin
    index, order and wire offset (the per-bin `off` table) past the old
    10-bit bin field and 2¹⁴ wire offsets: used bins up to 16 382, offsets
    up to ~6·U."""
    used, bits, off = (np.asarray(t) for t in SLOTS[name])
    slots = split_eq.slot_table(used, bits, off)
    k, m, offs = split_eq.unpack_slots(slots)
    active = np.nonzero(bits)[0]
    assert slots.dtype == np.int32 and slots.shape == (active.size, 2)
    by_bin = {int(u): j for j, u in enumerate(used)}
    j = np.array([by_bin[int(u)] for u in k])
    assert sorted(j.tolist()) == sorted(active.tolist())
    assert np.array_equal(2 * m, bits[j]) and np.array_equal(offs, off[j])
    assert np.all(np.diff(offs) == 2 * m[:-1]) and np.all(np.diff(m) >= 0)
    assert offs.max() >= 1 << 14 and k.max() >= 1 << 10
    if name.startswith("U = "):
        assert k.max() == 16382


TIMED_PICKS = {"gf3-4096": (2, 1, True), "gf3-8192": (4, 1, True),
               "gf3-16384": (8, 4, False)}


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_geometry_picks_its_layout(name):
    """Kernels 2 and A (`fused_eq_geometry`, both `demap` values) take the
    teamed layout at every wide band — their staged layout holds fewer
    than STAGED_MIN_WARPS warps an SM at gf3-4096 and gf3-8192 and fits no
    warp count at gf3-16384 — with the team, blocks and Ĥ placement of
    `teamed_geometry`, which are the launches timed fastest on the card:
    at B = 1024 a block a frame with Ĥ staged, teams of 2 warps at
    gf3-4096 and 4 at gf3-8192; at gf3-16384 (B = 64) teams of 8 over 4
    blocks a frame; one recording, a block per symbol and teams of 8.
    Kernel B (`demap_geometry`, uniform and loaded) takes the staged layout
    at gf3-4096 and gf3-8192 and the streamed one at gf3-16384, whose staged
    layout fits no warp count; its forced streamed layout
    (`streamed_geometry`) keeps the staged warps."""
    cfg = WIDE[name]
    B = 64 if name == "gf3-16384" else 1024
    streamed = name == "gf3-16384"
    U, P, D = cfg.n_used, cfg.n_pilots, cfg.n_data_symbols
    for d in (True, False):
        geo = eq_layout.fused_eq_geometry(cfg, B, demap=d)
        assert geo.layout == "teamed" and geo.nbuf == 0 and not geo.spill
        assert geo == eq_layout.teamed_geometry(U, P, D, B, device.H100_SMS,
                                                d)
        # the launches timed fastest on the card (PERF.md §6): (team,
        # blocks a frame, Ĥ staged), and at B = 1 a block per symbol
        assert (geo.team, geo.blocks, geo.stage_h) == TIMED_PICKS[name]
        one = eq_layout.fused_eq_geometry(cfg, 1, demap=d)
        assert (one.team, one.blocks, one.stage_h) == (8, D, False)
        staged = eq_layout.pick_warps(D, B, device.H100_SMS,
                                      lambda w, nbuf: eq_layout
                                      .staged_smem_bytes(U, P, w, nbuf, d))
        assert (staged is None) == streamed
        assert geo.smem <= device.SMEM_BLOCK
    geos, forced = [], []
    for c in (cfg, loaded(cfg)):
        geos.append(eq_layout.demap_geometry(c, B))
        forced.append(eq_layout.streamed_geometry(c, B))
    for geo, f in zip(geos, forced):
        assert (geo.layout == "streamed") == streamed
        assert f.layout == "streamed"
        assert f.nbuf == 0 and (f.warps, f.passes) == (geo.warps, geo.passes)
        assert f.smem <= geo.smem <= device.SMEM_BLOCK
    if streamed:
        assert geos[0].smem == 4 * 16


def test_spilled_layout_past_the_pilot_scratch_bound():
    """The layouts' one limit in shared memory is one team's pilot scratch,
    the pilot positions, its three shared values and kernel 2's two sums
    of one warp (5P + 6 words) in a block: past MAX_SHARED_PILOTS pilots
    (n_fft = 65536 at spacing 2, chip_smoke.SPILL_BAND) kernels 2 and A
    take the spilled layout — the teamed one with no symbol buffers and
    the pilot scratch (4P floats a team) in a global buffer, shared memory
    only for the teams' shared values and kernel 2's two sums a warp —
    whose launch covers every (frame, data symbol) once across (block,
    team) and gives every block a symbol; at spacing 3 the teamed layout
    still fits. Forced (`spilled_geometry`) at config 5 the spill keeps the
    staged warps, one warp a team and one block a frame, so each frame's
    sums keep their order."""
    bound = eq_layout.MAX_SHARED_PILOTS
    assert 4 * (5 * bound + 6) <= device.SMEM_BLOCK \
        < 4 * (5 * (bound + 1) + 6)
    over = GF3_STANDARD.replace(**chip_smoke.SPILL_BAND)
    under = over.replace(pilot_spacing=3)
    assert (over.n_used, over.n_pilots) == (31232, 15616)
    assert under.n_pilots <= bound < over.n_pilots
    D, P = over.n_data_symbols, over.n_pilots
    for demap in (True, False):
        for B in (1, 4, 64):
            geo = eq_layout.fused_eq_geometry(over, B, demap=demap)
            assert geo.spill and geo.nbuf == 0
            assert geo.layout == "spilled" and not geo.stage_h
            assert geo.smem == 4 * (4 * geo.teams
                                    + (2 * geo.warps if demap else 0))
            assert geo.scratch_floats(B, P) == \
                B * geo.blocks * geo.teams * 4 * P
            seen = Counter((b, d) for b in range(B)
                           for blk in range(geo.blocks)
                           for g in range(geo.teams)
                           for d in geo.symbols(g, D, blk))
            assert len(seen) == B * D and set(seen.values()) == {1}
            assert all(any(geo.symbols(g, D, blk) for g in range(geo.teams))
                       for blk in range(geo.blocks))
        # the launch timed fastest at B = 4: a block per symbol, teams of 8
        geo = eq_layout.fused_eq_geometry(over, chip_smoke.SPILL_B,
                                          demap=demap)
        assert (geo.team, geo.blocks) == (8, D)
        geo = eq_layout.fused_eq_geometry(under, 8, demap=demap)
        assert geo.layout == "teamed" and not geo.spill
        assert geo.smem <= device.SMEM_BLOCK
        staged = eq_layout.fused_eq_geometry(GF3_STANDARD, 1024, demap=demap)
        forced = eq_layout.spilled_geometry(staged, GF3_STANDARD, demap)
        assert not staged.spill and staged.scratch_floats(1024, 35) == 0
        assert forced.spill and forced.nbuf == 0
        assert (forced.warps, forced.passes) == (staged.warps, staged.passes)
        assert (forced.team, forced.blocks) == (1, 1)


def test_spilled_layout_plain_tail_at_its_pilot_count():
    """At the spilled layout's band (U = 31 232, P = 15 616, built in the
    frequency domain as chip_smoke.spill_inputs builds it on the card) the
    plain tails the kernels are held to there agree: kernel 2's plain
    version is A's then B's (`fused_eq_demap_plain`), with the pilot fit
    tracking the planted 2e-4 rad/bin slope and every data bin decided as
    sent at 30 dB."""
    cfg = GF3_STANDARD.replace(n_data_symbols=2, **chip_smoke.SPILL_BAND)
    Y, H, nv = chip_smoke.spill_inputs(cfg, 1, torch.device("cpu"))
    llr, slope, cpe, evm, mabs = fused_eq.fused_eq_demap(cfg, Y, H, nv)
    eq, slope_a, cpe_a, nv_sym = split_eq.eq_track(cfg, Y, H, nv)
    assert torch.equal(slope, slope_a) and torch.equal(cpe, cpe_a)
    assert llr.shape == (1, cfg.raw_bits_per_frame)
    assert torch.all((slope - 2e-4).abs() < 2e-6)
    assert torch.all(torch.isfinite(evm)) and float(evm.max()) < 0.01
    llr_b, _, _ = split_eq.demap_bins_plain(cfg, eq, H, nv_sym)
    assert torch.equal(llr_b < 0, llr < 0)
