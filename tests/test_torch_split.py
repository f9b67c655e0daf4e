"""The bit-loaded receive path of gf3x_torch against gf3x on the CPU: the
loading tables and the loaded map/demap, the split tail's two plain
versions (kernel A `eq_track`, kernel B `demap_bins`) against gf3x's XLA
twin and its Pallas kernels in interpret mode, the whole loaded slice on
`bench.build_batch`, the loaded transmit waveform, and the `adapt` flow.

The CUDA kernels run only on the card: `chip_smoke.py` holds each against
its plain version there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from gf3x import GF3_STANDARD, GF3_TURBO
from gf3x import Modem as JModem
from gf3x.config import layout
from gf3x.models import frame as jframe
from gf3x.ops import adapt as jadapt
from gf3x.ops.chanest import estimate_channel as j_estimate
from gf3x.ops.constellation import qam_demap_llr as j_demap
from gf3x.ops.ofdm import ofdm_demodulate

from gf3x_torch import Modem as TModem
from gf3x_torch.models import frame as tframe
from gf3x_torch.ops import adapt as tadapt
from gf3x_torch.ops.constellation import qam_demap_llr as t_demap
from gf3x_torch.ops.kernels import fused_eq, split_eq

# the slice's table: the reference's own on-chip parity table
TABLE = tuple(int(x) for x in np.random.default_rng(5).choice(
    [0, 2, 4, 6], size=GF3_STANDARD.n_data_bins, p=[0.1, 0.4, 0.35, 0.15]))
LOADED = GF3_STANDARD.replace(bit_loading=TABLE)
MAX_DELAY = bench.MARGIN + LOADED.cp


def small(cfg, D=4):
    """The same geometry with D data symbols and no FEC (tail tests)."""
    return cfg.replace(n_data_symbols=D, fec="none")


def noisy_bodies(jm, B, sigma, seed):
    """B random frames from gf3x, cut at the prewindowed body, plus AWGN."""
    cfg = jm.cfg
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, cfg.payload_bits_per_frame), dtype=np.uint8)
    wav = np.asarray(jax.jit(jm.modulate_frames)(jnp.asarray(info)))
    a = cfg.preamble_len - cfg.cp // 4
    need = (cfg.n_known_symbols + cfg.n_data_symbols) * cfg.symbol_len
    body = wav[:, a: a + need] + rng.normal(0, sigma, (B, need))
    return body.astype(np.float32), info


def ref_tail_inputs(cfg, body):
    """gf3x's spectra, LS estimate and noise floor of the bodies, as NumPy."""
    Y = ofdm_demodulate(cfg, jnp.asarray(body))
    H, nv = j_estimate(cfg, Y[..., : cfg.n_known_symbols, :])
    return np.asarray(Y), np.asarray(H), np.asarray(nv)


def test_loading_tables_and_loaded_map_demap_match_gf3x():
    """Tables equal; map exact; demap ≤ 1e-5 relative; and each data bin's
    LLRs sit at its `demap_bin_tables` offset in gf3x's wire order."""
    cfg = small(LOADED)
    jt, tt = jframe.loading_tables(cfg), tframe.loading_tables(cfg)
    assert jt.gain == tt.gain and np.array_equal(jt.inv_perm, tt.inv_perm)
    assert [(m, p.tolist()) for m, p in jt.groups] == \
        [(m, p.tolist()) for m, p in tt.groups]

    rng = np.random.default_rng(0)
    R, D, nd = cfg.bits_per_ofdm_symbol, cfg.n_data_symbols, cfg.n_data_bins
    coded = rng.integers(0, 2, (3, D, R), dtype=np.uint8)
    ref = np.asarray(jframe.loaded_qam_map(cfg, jnp.asarray(coded)))
    got = tframe.loaded_qam_map(cfg, torch.as_tensor(coded)).numpy()
    assert np.array_equal(got, ref)

    data = (ref + (rng.normal(0, 0.01, ref.shape)
                   + 1j * rng.normal(0, 0.01, ref.shape))).astype(np.complex64)
    nv = rng.uniform(0.01, 0.1, (3, D, nd)).astype(np.float32)
    l_ref, e_ref = (np.asarray(x) for x in jframe.loaded_demap_llr(
        cfg, jnp.asarray(data), jnp.asarray(nv)))
    l_got, e_got = tframe.loaded_demap_llr(cfg, torch.as_tensor(data),
                                           torch.as_tensor(nv))
    assert l_got.shape == l_ref.shape == (3, D, R)
    assert np.max(np.abs(l_got.numpy() - l_ref)) <= 1e-5 * np.max(np.abs(l_ref))
    assert np.allclose(e_got.numpy(), e_ref, rtol=1e-5)
    assert np.array_equal(l_got.numpy() < 0, coded.astype(bool))

    used, bits, off = tframe.demap_bin_tables(cfg)
    assert np.array_equal(used, layout(cfg).data_pos)
    assert np.array_equal(bits, np.asarray(TABLE))
    y = jnp.asarray(data) * np.float32(1.0 / jt.gain)
    for j in np.nonzero(bits)[0]:
        one = np.asarray(j_demap(y[..., j], jnp.asarray(nv[..., j])
                                 * np.float32(1.0 / jt.gain ** 2), bits[j]))
        np.testing.assert_allclose(l_ref[..., off[j]: off[j] + bits[j]], one,
                                   rtol=1e-6, atol=1e-6 * np.max(np.abs(one)))


def test_eq_track_plain_matches_gf3x_and_pallas_interpret():
    """Kernel A's plain version against gf3x `_eq_tail` (data bins, nv_eff,
    slope, cpe) and against `eq_track_tpu(interpret=True)` transposed out of
    its (D, 2, U, lanes) layout: bins and noise floor ≤ 1e-4 relative,
    slope and cpe ≤ 1e-4 rad."""
    from gf3x.ops.pallas.fused_eq import LANES
    from gf3x.ops.pallas.split_eq import eq_track_tpu

    cfg = small(LOADED)
    jm = JModem(cfg)
    body, _ = noisy_bodies(jm, 3, 4e-3, 1)
    Y, H, nv = ref_tail_inputs(cfg, body)
    eq, slope, cpe, nv_sym = (t.numpy() for t in split_eq.eq_track_plain(
        cfg, torch.as_tensor(Y), torch.as_tensor(H), torch.as_tensor(nv)))

    data_r, nveff_r, (slope_r, cpe_r) = (
        jax.tree.map(np.asarray, jm._eq_tail(jnp.asarray(Y), jnp.asarray(H),
                                             jnp.asarray(nv))))
    _, data = tframe.split_pilots(cfg, torch.as_tensor(eq))
    _, inv_csi = tframe.split_pilots(
        cfg, 1.0 / torch.clamp(torch.as_tensor(np.abs(H) ** 2), min=1e-12))
    nveff = nv_sym[..., None] * inv_csi.numpy()[:, None, :]

    def rel(a, b):
        return np.max(np.abs(a - b)) / np.mean(np.abs(b))

    assert rel(data.numpy(), data_r) <= 1e-4
    assert rel(nveff, nveff_r) <= 1e-4
    assert np.max(np.abs(slope - slope_r)) <= 1e-4
    assert np.max(np.abs(cpe - cpe_r)) <= 1e-4

    B, K = Y.shape[0], cfg.n_known_symbols
    y_ri = np.zeros((cfg.n_data_symbols, 2, cfg.n_used, LANES), np.float32)
    y_ri[:, 0, :, :B] = Y[:, K:].real.transpose(1, 2, 0)
    y_ri[:, 1, :, :B] = Y[:, K:].imag.transpose(1, 2, 0)
    h_ri = np.ones((2, cfg.n_used, LANES), np.float32)
    h_ri[0, :, :B], h_ri[1, :, :B] = H.real.T, H.imag.T
    nv8 = np.ones((8, LANES), np.float32)
    nv8[0, :B] = nv
    eq_p, dA = (np.asarray(x) for x in eq_track_tpu(
        cfg, jnp.asarray(y_ri), jnp.asarray(h_ri), jnp.asarray(nv8),
        interpret=True))
    eq_p = (eq_p[:, 0, :, :B] + 1j * eq_p[:, 1, :, :B]).transpose(2, 0, 1)
    assert rel(eq, eq_p) <= 1e-4
    assert np.max(np.abs(slope - dA[:, 0, :B].T)) <= 1e-4
    assert np.max(np.abs(cpe - dA[:, 1, :B].T)) <= 1e-4
    assert rel(nv_sym, dA[:, 2, :B].T) <= 1e-4


@pytest.mark.parametrize("which", ["loaded", "qam64"])
def test_split_tail_matches_xla_twin(which):
    """The port's split tail (`_split_eq_demap`, plain versions) against
    gf3x `_demod_prewindowed(use_pallas=False)`: hard decisions exact, soft
    ≤ 1e-4·mean|LLR|, slope/cpe ≤ 1e-4 rad, EVM and mean|LLR| ≤ 1e-4
    relative; and at 64-QAM the fused tail gives the same numbers."""
    cfg = small(LOADED if which == "loaded" else GF3_TURBO)
    jm, tm = JModem(cfg), TModem(cfg, device="cpu")
    body, info = noisy_bodies(jm, 3, 3e-3, 2)
    llr_r, (_, _, sl_r, cp_r, evm_r, mab_r, *_) = jax.tree.map(
        np.asarray, jm._demod_prewindowed(jnp.asarray(body),
                                          use_pallas=False))
    S = cfg.n_known_symbols + cfg.n_data_symbols
    syms = torch.as_tensor(body).reshape(3, S, cfg.symbol_len)[..., cfg.cp:]
    Y, H, nv, _, _ = tm._estimate(syms)
    outs = [tm._split_eq_demap(Y, H, nv)]
    if which == "qam64":
        outs.append(tm._fused_eq_demap(Y, H, nv))
    for llr, sl, cp, evm, mab in outs:
        llr = llr.numpy()
        assert llr.shape == llr_r.shape == (3, cfg.raw_bits_per_frame)
        assert np.array_equal(llr < 0, llr_r < 0)
        assert np.max(np.abs(llr - llr_r)) <= 1e-4 * np.mean(np.abs(llr_r))
        assert np.max(np.abs(sl.numpy() - sl_r)) <= 1e-4
        assert np.max(np.abs(cp.numpy() - cp_r)) <= 1e-4
        assert np.allclose(evm.numpy(), evm_r, rtol=1e-4)
        assert np.allclose(mab.numpy(), mab_r, rtol=1e-4)
    coded = np.asarray(jm.fec_encode(jnp.asarray(info)))
    assert np.mean((outs[0][0].numpy() < 0) != coded) < 1e-3


@pytest.mark.parametrize("which", ["loaded", "qam64"])
def test_split_tail_matches_pallas_interpret(which):
    """The same tail against gf3x `_split_eq_demap(interpret=True)` — the
    Pallas kernels A and B — through `coded_stream_llr` on the same Y, H
    and noise floor: hard decisions exact, soft within gf3x's own bound
    for its kernels (0.03·mean|LLR|, tests/test_pallas_kernels.py)."""
    cfg = small(LOADED if which == "loaded" else GF3_TURBO)
    jm, tm = JModem(cfg), TModem(cfg, device="cpu")
    body, _ = noisy_bodies(jm, 4, 2e-3, 3)
    Y, H, nv = ref_tail_inputs(cfg, body)
    fused, _ = jm._split_eq_demap(jnp.asarray(Y), jnp.asarray(H),
                                  jnp.asarray(nv), (4,), interpret=True)
    ref = np.asarray(jm.coded_stream_llr(fused, (4,)))
    llr, *_ = tm._split_eq_demap(torch.as_tensor(Y), torch.as_tensor(H),
                                 torch.as_tensor(nv))
    sign = 1.0 - 2.0 * tm.scramble.float()
    got = (llr[:, tm.fec_index] * sign).numpy()
    assert np.array_equal(got < 0, ref < 0)
    assert np.max(np.abs(got - ref)) < 0.03 * np.mean(np.abs(ref))


@pytest.fixture(scope="module")
def loaded_batch():
    """bench.build_batch at B = 4 with the slice's table, decoded once by
    gf3x (bounded sync)."""
    jm = JModem(LOADED, max_delay=MAX_DELAY)
    rx, payload, delays = bench.build_batch(jm, 4, bench.MARGIN,
                                            np.random.default_rng(0))
    bits, diag = jm._decode_jit(jnp.asarray(rx))
    return rx, payload, np.asarray(bits), jax.device_get(diag)


def test_loaded_slice_matches_gf3x(loaded_batch):
    """The whole loaded slice on bench.build_batch(B=4): payload bits equal
    gf3x's and CRC ok on every row, through `demodulate` and through
    `decode_batch`; diagnostics within the config-5 test's tolerances
    (sync within 2, H / noise_var / isi_var ≤ 1e-3 rel, slope/cpe ≤ 1e-4
    rad, evm and mean|LLR| ≤ 1e-3 rel, fec_unsat exact)."""
    rx, payload, j_bits, jd = loaded_batch
    tm = TModem(LOADED, max_delay=MAX_DELAY, device="cpu")
    bits, d = tm.demodulate(torch.as_tensor(rx))
    assert np.array_equal(bits.numpy(), j_bits)
    results = tm.decode_batch(rx)
    assert len(results) == 4
    for res, b in zip(results, bits.numpy()):
        assert res.crc_ok and res.payload == payload
        assert np.array_equal(res.bits, b)
    assert np.max(np.abs(d.sync_start.numpy()
                         - np.asarray(jd.sync_start))) <= 2
    Hj = np.asarray(jd.H)[..., 0] + 1j * np.asarray(jd.H)[..., 1]
    assert np.array_equal(results[2].diag.H, d.H.numpy()[2])

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
    assert np.array_equal(d.fec_unsat.numpy(), np.asarray(jd.fec_unsat))
    assert (d.fec_iters.numpy() <= LOADED.ldpc_iters).all()


def test_loaded_encode_waveform_matches():
    """One loaded frame, bytes → waveform: ≤ 1e-5 abs."""
    jm, tm = JModem(LOADED), TModem(LOADED, device="cpu")
    payload = np.random.default_rng(1).integers(0, 256, 700, np.uint8).tobytes()
    ref = jm.encode(payload, "l.bin")
    got = tm.encode(payload, "l.bin")
    assert got.shape == ref.shape == (LOADED.frame_len,)
    assert np.max(np.abs(got - ref)) <= 1e-5


def _room(wav, rng, snr_db=22.0):
    """A two-path channel (a notch in the band), a 500-sample onset, AWGN."""
    rx = np.convolve(wav, [1.0, 0.0, 0.0, 0.7])[: wav.size]
    rx = np.concatenate([np.zeros(500, np.float32), rx,
                         np.zeros(1500, np.float32)])
    p = float(np.mean(wav ** 2))
    noise = rng.standard_normal(rx.size) * np.sqrt(p / 10 ** (snr_db / 10))
    return (rx + noise).astype(np.float32)


def test_adapt_flow_on_the_port():
    """Probe decode → `bit_loading_from_probe` → loaded modem → decode
    again, all on the port: the copied `adapt` gives gf3x's table on the
    same host diag, and the adapted frame decodes CRC-ok."""
    rng = np.random.default_rng(6)
    probe = TModem(GF3_STANDARD, device="cpu")
    res = probe.decode(_room(probe.encode(b"probe", "p"), rng))
    assert res.crc_ok
    table = tadapt.bit_loading_from_probe(res.diag, GF3_STANDARD)
    assert table == jadapt.bit_loading_from_probe(res.diag, GF3_STANDARD)
    assert tadapt.recommend_preset(res.diag, GF3_STANDARD) == \
        jadapt.recommend_preset(res.diag, GF3_STANDARD)
    assert len(set(table)) > 1                       # the notch shows
    adapted = TModem(GF3_STANDARD.replace(bit_loading=table), device="cpu")
    payload = bytes(range(256)) * 2
    out = adapted.decode(_room(adapted.encode(payload, "a"), rng))
    assert out.crc_ok and out.payload == payload
    assert int(out.diag.fec_unsat) == 0


def test_tail_route_by_config():
    """Loaded → split, every uniform order → fused; the fused wrapper
    refuses a loaded config on any device."""
    assert TModem(small(LOADED), device="cpu")._tail_route() == "split"
    for cfg in (GF3_STANDARD, GF3_TURBO, GF3_STANDARD.replace(
            bits_per_symbol=4)):
        assert TModem(small(cfg), device="cpu")._tail_route() == "fused"
    cfg = small(LOADED)
    Y = torch.zeros(1, 8, cfg.n_used, dtype=torch.complex64)
    H = torch.ones(1, cfg.n_used, dtype=torch.complex64)
    with pytest.raises(ValueError, match="split"):
        fused_eq.fused_eq_demap(cfg, Y, H, torch.ones(1))


# ---- kernel B's wire-order slot table (`split_eq.slot_table`), checked
# here because the kernel runs only on the card

ZEROED = GF3_STANDARD.replace(bit_loading=tuple(
    (0, 6, 2, 0, 4, 0, 0, 2)[j % 8] for j in range(GF3_STANDARD.n_data_bins)))
SLOT_CONFIGS = {"config5": GF3_STANDARD, "gf3-turbo": GF3_TURBO,
                "loaded": LOADED, "zero-bit bins": ZEROED}


@pytest.mark.parametrize("name", list(SLOT_CONFIGS))
def test_slot_table_is_the_wire_order(name):
    """The slot table kernel B walks, from the Modem's per-bin tables: its
    slots are a permutation of the active bins (0-bit bins have none), each
    order's slots are contiguous (group-sorted, so a warp runs one order
    but at a boundary), the offsets are the running sum of 2m and end at R
    (the `off` table's values); and scattering each bin's LLRs (the plain
    demap of that bin alone at its order) through the table gives
    `demap_bins_plain`'s wire-order LLRs exactly."""
    cfg = small(SLOT_CONFIGS[name])
    used, bits, off = tframe.demap_bin_tables(cfg)
    slots = split_eq.slot_table(used, bits, off)
    k, m, offs = split_eq.unpack_slots(slots)
    active = np.nonzero(bits)[0]
    assert slots.dtype == np.int32 and slots.shape == (cfg.n_active_bins, 2)
    assert sorted(k.tolist()) == sorted(used[active].tolist())
    for order in np.unique(m):
        at = np.nonzero(m == order)[0]
        assert np.array_equal(at, np.arange(at[0], at[-1] + 1))
    assert np.all(np.diff(m) >= 0)
    assert offs[0] == 0 and np.array_equal(offs[1:], np.cumsum(2 * m)[:-1])
    assert offs[-1] + 2 * m[-1] == cfg.bits_per_ofdm_symbol
    data_of_used = {int(u): j for j, u in enumerate(used)}
    assert np.array_equal(offs, off[[data_of_used[int(u)] for u in k]])

    rng = np.random.default_rng(11)
    B, D, U = 3, cfg.n_data_symbols, cfg.n_used
    eq = torch.as_tensor((rng.normal(0, 0.7, (B, D, U))
                          + 1j * rng.normal(0, 0.7, (B, D, U)))
                         .astype(np.complex64))
    H = torch.as_tensor((rng.normal(0, 1, (B, U))
                         + 1j * rng.normal(0, 1, (B, U))).astype(np.complex64))
    nv_sym = torch.as_tensor(rng.uniform(0.01, 0.2, (B, D))
                             .astype(np.float32))
    llr, _, _ = split_eq.demap_bins_plain(cfg, eq, H, nv_sym)
    _, data = tframe.split_pilots(cfg, eq)
    _, inv_csi = tframe.split_pilots(
        cfg, 1.0 / torch.clamp(torch.abs(H) ** 2, min=1e-12))
    nv_eff = nv_sym[..., None] * inv_csi[:, None, :]
    g = (tframe.loading_tables(cfg).gain if cfg.bit_loading is not None
         else 1.0)
    got = torch.full((B, D, cfg.bits_per_ofdm_symbol), float("nan"))
    for u, mm, o in zip(k, m, offs):
        j = data_of_used[int(u)]
        got[..., o: o + 2 * mm] = t_demap(
            data[..., j] * np.float32(1.0 / g),
            nv_eff[..., j] * np.float32(1.0 / g ** 2), 2 * int(mm))
    assert torch.equal(got.reshape(B, -1), llr)


def test_demap_constants_refuse_tables_off_the_config():
    """Kernel B's launch constants refuse tables whose bins would carry
    other than 0/2/4/6 bits, other than R bits in all, or a used bin past
    n_used: the kernel writes each slot's LLRs at its offset in an R-float
    row."""
    cfg = small(LOADED)
    used, bits, off = tframe.demap_bin_tables(cfg)
    cpu = torch.device("cpu")
    slots, inv_g, inv_g2, R, _, _ = split_eq._demap_constants(
        cfg, (used, bits, off), cpu)
    assert R == cfg.bits_per_ofdm_symbol
    assert slots.shape == (cfg.n_active_bins, 2)
    assert inv_g == np.float32(1.0 / tframe.loading_tables(cfg).gain)
    split_eq._LAUNCH.clear()
    wide, heavy = used.copy(), bits.copy()
    wide[np.nonzero(bits)[0][0]] = cfg.n_used
    heavy[np.nonzero(bits == 0)[0][0]] = 8
    for bad in ((wide, bits, off), (used, heavy, off),
                (used, np.where(bits == 2, 4, bits), off)):
        with pytest.raises(ValueError):
            split_eq._demap_constants(cfg, bad, cpu)

