"""The plain versions of gf3x_torch's first three CUDA kernels, against the
gf3x functions they replace (kernel 2's against its XLA twin and its Pallas
kernel), on the CPU (where every kernel wrapper runs its plain version);
plus the wrappers' dispatch rule and the build recipe.

The kernels themselves run only on the card: `chip_smoke.py` compares each
with its plain version there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gf3x import GF3_STANDARD
from gf3x import Modem as JModem
from gf3x.config import layout as j_layout
from gf3x.fec.ldpc import LdpcCode as JCode
from gf3x.models.frame import interleave_bits as j_interleave

import chip_smoke
from gf3x_torch import Modem as TModem
from gf3x_torch.config import CONFIG1_LOOPBACK
from gf3x_torch.convert import load_reference_tables
from gf3x_torch.fec.codes import N_BLOCK_COLS
from gf3x_torch.fec.ldpc import LdpcCode as TCode
from gf3x_torch.ops.kernels import (czt, fec_gather, fused_eq, gather_cut,
                                    ldpc_bp, llr_hist, split_eq)
from gf3x_torch.utils import device


@pytest.mark.parametrize("bps", [2, 4, 6])
def test_fused_eq_demap_plain_matches_xla_twin(bps):
    """Kernel 2's plain version through the port's receive tail vs gf3x's
    `_demod_prewindowed(use_pallas=False)` on noisy frames: hard decisions
    exact, soft ≤ 1e-4·mean|LLR|, slope/cpe ≤ 1e-4 rad, evm and mean|LLR|
    ≤ 1e-4 rel."""
    cfg = GF3_STANDARD.replace(bits_per_symbol=bps, fec="none",
                               n_data_symbols=6)
    jm, tm = JModem(cfg), TModem(cfg, device="cpu")
    rng = np.random.default_rng(bps)
    info = rng.integers(0, 2, (3, cfg.payload_bits_per_frame), dtype=np.uint8)
    wav = np.asarray(jm.modulate_frames(jnp.asarray(info)))
    a = cfg.preamble_len - cfg.cp // 4
    S = cfg.n_known_symbols + cfg.n_data_symbols
    need = S * cfg.symbol_len
    body = (wav[:, a: a + need]
            + rng.normal(0, 8e-3, (3, need))).astype(np.float32)

    llr_r, (_, _, sl_r, cp_r, evm_r, mab_r, *_) = jm._demod_prewindowed(
        jnp.asarray(body), use_pallas=False)
    syms = torch.as_tensor(body).reshape(3, S, cfg.symbol_len)[..., cfg.cp:]
    llr_t, (_, _, sl_t, cp_t, evm_t, mab_t, *_) = tm._demod_syms(syms)
    llr_r = np.asarray(llr_r)
    llr_t = llr_t.numpy()
    assert llr_t.shape == llr_r.shape == (3, cfg.raw_bits_per_frame)
    assert np.array_equal(llr_t < 0, llr_r < 0)
    assert np.max(np.abs(llr_t - llr_r)) <= 1e-4 * np.mean(np.abs(llr_r))
    assert np.max(np.abs(sl_t.numpy() - np.asarray(sl_r))) <= 1e-4
    assert np.max(np.abs(cp_t.numpy() - np.asarray(cp_r))) <= 1e-4
    assert np.allclose(evm_t.numpy(), np.asarray(evm_r), rtol=1e-4)
    assert np.allclose(mab_t.numpy(), np.asarray(mab_r), rtol=1e-4)
    # and the LLRs decode: hard bits match the transmitted channel bits
    coded = np.asarray(jm.fec_encode(jnp.asarray(info)))
    assert np.mean((llr_t < 0) != coded) < 1e-3


@pytest.mark.parametrize("bps", [2, 4])
def test_fused_eq_demap_plain_matches_pallas_interpret(bps):
    """Kernel 2's plain version against gf3x's Pallas kernel itself
    (`Modem._fused_eq_demap(interpret=True)`) on the same Y, H and noise
    floor, compared in the canonical `coded_stream_llr` order: hard
    decisions exact, slope/cpe ≤ 1e-4 rad, and soft values within
    1e-4·mean|LLR|, inside gf3x's own bound for that kernel against its
    twin, 0.02·mean|LLR| + 1e-3 (tests/test_pallas_kernels.py). The
    Pallas kernel takes its angles from a polynomial and the port from
    atan2f; the gaps observed here are 1.0e-5·mean|LLR| at QPSK and
    2.7e-5·mean|LLR| at 16-QAM."""
    from gf3x.ops.chanest import estimate_channel
    from gf3x.ops.ofdm import ofdm_demodulate

    cfg = GF3_STANDARD.replace(bits_per_symbol=bps, fec="none",
                               n_data_symbols=6)
    jm, tm = JModem(cfg), TModem(cfg, device="cpu")
    rng = np.random.default_rng(10 + bps)
    info = rng.integers(0, 2, (3, cfg.payload_bits_per_frame), dtype=np.uint8)
    wav = np.asarray(jm.modulate_frames(jnp.asarray(info)))
    a = cfg.preamble_len - cfg.cp // 4
    need = (cfg.n_known_symbols + cfg.n_data_symbols) * cfg.symbol_len
    body = jnp.asarray((wav[:, a: a + need] + rng.normal(0, 3e-3, (3, need)))
                       .astype(np.float32))
    Y = ofdm_demodulate(cfg, body)
    H, nv = estimate_channel(cfg, Y[..., : cfg.n_known_symbols, :])
    fused, (_, _, sl_p, cp_p, _, _) = jm._fused_eq_demap(Y, H, nv, (3,),
                                                         interpret=True)
    ref = np.asarray(jm.coded_stream_llr(fused, (3,)))
    llr, slope, cpe, _, _ = fused_eq.fused_eq_demap_plain(
        cfg, *(torch.as_tensor(np.array(x)) for x in (Y, H, nv)))
    got = tm.coded_stream_llr(llr).numpy()
    assert got.shape == ref.shape == (3, cfg.raw_bits_per_frame)
    assert np.array_equal(got < 0, ref < 0)
    scale = np.mean(np.abs(ref))
    assert np.max(np.abs(got - ref)) <= 1e-4 * scale
    assert np.max(np.abs(slope.numpy() - np.asarray(sl_p))) <= 1e-4
    assert np.max(np.abs(cpe.numpy() - np.asarray(cp_p))) <= 1e-4


def _noisy_codewords(code, L, seed, sigma=0.8):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(L, code.k), dtype=np.uint8)
    c = code.encode(u)
    y = (1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)
    return u, (2 * y / sigma ** 2).astype(np.float32)


@pytest.mark.parametrize("z,rate", [(24, "1/2"), (24, "3/4"), (96, "1/2"),
                                    (96, "3/4"), (24, "2/3"), (96, "5/6")])
def test_minsum_plain_bit_identical_to_xla_twin(z, rate):
    """Kernel 3's plain version vs `LdpcCode._minsum_xla` (and the
    `decode_jax(use_pallas=False)` surface): info bits, unsat flags and the
    totals' signs bit-identical; per-codeword passes ≤ the batch-wide count,
    with the slowest codeword equal to it. The totals themselves agree to
    ≤ 1e-5 of their largest magnitude, not bit for bit: XLA:CPU contracts
    `α·p·m − c2v` into a fused multiply-add, while the port (and its CUDA
    kernel, built with --fmad=false) rounds the product and the difference
    separately."""
    jc = JCode(z, rate)
    iters = 12
    u, llr = _noisy_codewords(jc, 12, z + len(rate),
                              sigma=0.8 if rate == "1/2" else 0.5)
    tot_r, it_r, uns_r = jc._minsum_xla(
        jnp.asarray(llr).reshape(-1, N_BLOCK_COLS, z), iters, True)
    tot_t, uns_t, pas_t = ldpc_bp.minsum_totals_plain(
        torch.as_tensor(llr), z, rate, iters)
    tot_r = np.asarray(tot_r).reshape(12, -1)
    assert np.array_equal(tot_t.numpy() < 0, tot_r < 0)
    assert np.max(np.abs(tot_t.numpy() - tot_r)) <= 1e-5 * np.max(np.abs(tot_r))
    assert np.array_equal(uns_t.numpy(), np.asarray(uns_r))
    assert int(pas_t.max()) == int(it_r) and int(pas_t.min()) >= 0

    bits_r, _, uns_r2 = jc.decode_jax(jnp.asarray(llr), iters,
                                      use_pallas=False, with_diag=True)
    bits_t, pas2, uns_t2 = TCode(z, rate).decode(torch.as_tensor(llr), iters)
    assert np.array_equal(bits_t.numpy(), np.asarray(bits_r))
    assert np.array_equal(uns_t2.numpy(), np.asarray(uns_r2))
    assert np.array_equal(pas2.numpy(), pas_t.numpy())
    assert np.mean(bits_t.numpy() != u) < 0.01          # and it decodes


def test_minsum_plain_matches_pallas_interpret():
    """Against the TPU kernel itself (Pallas interpret mode, z = 24, one
    128-lane block): totals' signs and unsat flags equal, passes within the
    block's count."""
    from gf3x.ops.pallas.ldpc_bp import minsum_totals_tpu

    z, L = 24, 128
    jc = JCode(z)
    _, llr = _noisy_codewords(jc, L, 5, sigma=0.85)
    lam_t = jnp.asarray(llr).reshape(L, N_BLOCK_COLS, z).transpose(1, 2, 0)
    tot_p, diag = minsum_totals_tpu(lam_t, z, 8, interpret=True)
    tot_p = np.asarray(tot_p).transpose(2, 0, 1).reshape(L, -1)
    tot_t, uns_t, pas_t = ldpc_bp.minsum_totals_plain(
        torch.as_tensor(llr), z, "1/2", 8)
    assert np.array_equal(tot_t.numpy() < 0, tot_p < 0)
    assert np.array_equal(uns_t.numpy(), np.asarray(diag)[0] > 0.5)
    assert int(pas_t.max()) == int(np.asarray(diag)[1, 0])


def test_encode_matches_gf3x():
    """Systematic encode through the parity projector: exact, and the
    projector is the same table."""
    jc, tc = JCode(96), TCode(96)
    assert np.array_equal(tc.P, jc.t.P)
    u = np.random.default_rng(2).integers(0, 2, (5, jc.k), dtype=np.uint8)
    assert np.array_equal(tc.encode(torch.as_tensor(u)).numpy(), jc.encode(u))


FEC_GATHER_CONFIGS = {
    "config5": GF3_STANDARD,
    "gf3-8192": GF3_STANDARD.replace(**chip_smoke.WIDE_BANDS["gf3-8192"]),
    "bit-loaded": GF3_STANDARD.replace(bit_loading=chip_smoke.loading_table(
        GF3_STANDARD.n_data_bins)),
    "uninterleaved": GF3_STANDARD.replace(interleave=False),
}


@pytest.mark.parametrize("name", list(FEC_GATHER_CONFIGS))
def test_fec_gather_matches_coded_stream_llr(name):
    """The FEC ingest's static gather (deinterleave + descramble) lands each
    LLR where gf3x's `coded_stream_llr` puts it: the wrapper (its plain
    version on CPU tensors) on the Modem's int32 table and scramble bytes
    gives gf3x's `interleave_bits(..., inverse=True)` (none where the config
    does not interleave) times gf3x's descrambler over the codewords,
    exactly; and the table holds those positions."""
    cfg = FEC_GATHER_CONFIGS[name]
    tm = TModem(cfg, device="cpu")
    used = cfg.n_codewords * cfg.ldpc_n
    raw = cfg.raw_bits_per_frame
    llr = np.random.default_rng(3).standard_normal((3, raw)).astype(
        np.float32)
    sign = 1.0 - 2.0 * j_layout(cfg).scramble.astype(np.float32)
    if cfg.interleave:
        ref = np.asarray(j_interleave(cfg, jnp.asarray(llr), inverse=True))
        pos = np.asarray(j_interleave(cfg, jnp.arange(raw), inverse=True))
    else:
        ref, pos = llr, np.arange(raw)
    assert tm.codeword_index.dtype == torch.int32
    assert np.array_equal(tm.codeword_index.numpy(), pos[:used])
    # the card's tiled kernel reads no index: the interleaver's is the
    # reversal of the axes the Modem names, and an identity names none
    if cfg.interleave:
        assert np.array_equal(fec_gather.reversal_index(*tm._fec_axes), pos)
    else:
        assert tm._fec_axes is None
    before = fec_gather.fec_gather.launches
    got = fec_gather.fec_gather(torch.as_tensor(llr), tm.codeword_index,
                                tm.scramble, tm._fec_axes)
    assert fec_gather.fec_gather.launches == before
    assert got.shape == (3, used)
    assert np.array_equal(got.numpy(), (ref * sign)[:, :used])
    lam = tm._codeword_llrs(torch.as_tensor(llr))
    assert torch.equal(lam, got.reshape(-1, cfg.ldpc_n))


def test_fec_gather_wrapper_dispatch():
    """A CPU tensor runs the plain version and launches nothing; a tensor
    that is not float32, a table of the wrong type or shape, and a tensor
    neither on the CPU nor on a CUDA device are refused, with no launch."""
    tm = TModem(GF3_STANDARD, device="cpu")
    idx, scr = tm.codeword_index, tm.scramble
    llr = torch.randn(2, GF3_STANDARD.raw_bits_per_frame)
    before = fec_gather.fec_gather.launches
    assert torch.equal(fec_gather.fec_gather(llr, idx, scr),
                       fec_gather.fec_gather_plain(llr, idx, scr))
    for bad in ((llr.double(), idx, scr), (llr.half(), idx, scr),
                (llr[0], idx, scr), (llr[:, :-1], idx, scr),
                (llr, idx.long(), scr), (llr, idx[:, None], scr),
                (llr, idx, scr.float()), (llr, idx, scr[:-1]),
                (llr.to("meta"), idx.to("meta"), scr.to("meta")),
                (llr.to("meta"), idx, scr),
                (llr, idx, scr, (20, 7, 69)),
                (llr.to("meta"), idx.to("meta"), scr.to("meta"),
                 tm._fec_axes)):
        with pytest.raises(ValueError):
            fec_gather.fec_gather(*bad)
    assert fec_gather.fec_gather.launches == before


@pytest.mark.parametrize("pass_", ["pre", "post"])
def test_czt_wrapper_dispatch(pass_):
    """The chirp-z passes' wrappers: CPU tensors run the plain versions and
    launch nothing — `czt_pre` reads rows at their strides, multiplies by
    the pre-chirp and pads with zeros to L; `czt_post` takes the first M
    columns times the post-chirp — and a wrong type, shape or device is
    refused, with no launch."""
    rng = np.random.default_rng(3)
    N, L, M, cp = 16, 40, 6, 4
    body = torch.as_tensor(rng.standard_normal((3, 2 * (N + cp))),
                           dtype=torch.float32)
    sym = body.reshape(3, 2, N + cp)[..., cp:]
    pre = torch.as_tensor(np.exp(1j * rng.uniform(0, 7, N)),
                          dtype=torch.complex64)
    z = torch.randn(6, L, dtype=torch.complex64)
    post = torch.as_tensor(np.exp(1j * rng.uniform(0, 7, M)),
                           dtype=torch.complex64)
    fn = czt.czt_pre if pass_ == "pre" else czt.czt_post
    before = fn.launches
    if pass_ == "pre":
        got = czt.czt_pre(sym, pre, L)
        assert got.shape == (6, L) and torch.all(got[:, N:] == 0)
        assert torch.equal(got[:, :N], sym.reshape(6, N) * pre)
        bads = ((sym.double(), pre, L), (sym, pre.to(torch.complex128), L),
                (sym, pre[:-1], L), (sym, pre, N - 1),
                (sym.to("meta"), pre.to("meta"), L), (sym.to("meta"), pre, L))
    else:
        got = czt.czt_post(z, post)
        assert torch.equal(got, z[:, :M] * post)
        bads = ((z.to(torch.complex128), post), (z, post.to(torch.complex128)),
                (z[0], post), (z[:, :M - 1], post), (z, post[None]),
                (z.to("meta"), post.to("meta")), (z, post.to("meta")))
    for bad in bads:
        with pytest.raises(ValueError):
            fn(*bad)
    assert fn.launches == before


def test_czt_fused_wrapper_dispatch():
    """The fused chirp-z kernel's wrapper: CPU tensors run the plain
    version (on the cut's strided view, rows of two recordings) and launch
    nothing; a wrong dtype, a table of the wrong shape, an L it is not
    built for, N past 2L/3 or M past L/3, or tensors on another device
    than the CPU or one card are refused, with no launch."""
    rng = np.random.default_rng(4)
    L, N, M, cp = 6144, 4096, 1120, 1024
    body = torch.as_tensor(rng.standard_normal((2, 3 * (N + cp))),
                           dtype=torch.float32)
    sym = body.reshape(2, 3, N + cp)[..., cp:]
    pre, hr, post = (torch.as_tensor(np.exp(1j * rng.uniform(0, 7, n)),
                                     dtype=torch.complex64)
                     for n in (N, L, M))
    before = czt.czt_fused.launches
    got = czt.czt_fused(sym, pre, hr, post)
    assert got.shape == (6, M) and got.dtype == torch.complex64
    assert torch.equal(got, czt.czt_fused_plain(sym, pre, hr, post))
    assert torch.equal(got[3:], czt.czt_fused_plain(sym[1], pre, hr, post))
    long_pre = torch.ones(L + 3, dtype=torch.complex64)
    bads = ((sym.double(), pre, hr, post), (sym, pre.to(torch.complex128),
                                            hr, post),
            (sym, pre, hr.to(torch.complex128), post),
            (sym, pre, hr, post.to(torch.complex128)),
            (sym, pre[:-1], hr, post), (sym, pre, hr[:-1], post),
            (sym, pre, hr[None], post), (sym, pre, hr, post[None]),
            (sym, pre, torch.ones(16384, dtype=torch.complex64), post),
            (torch.zeros(2, L + 3), long_pre, hr, post),
            (torch.zeros(2, N + 1), torch.ones(N + 1, dtype=torch.complex64),
             hr, post),
            (sym, pre, hr, torch.ones(L // 3 + 1, dtype=torch.complex64)),
            (sym.to("meta"), pre.to("meta"), hr.to("meta"), post.to("meta")),
            (sym, pre, hr.to("meta"), post))
    for bad in bads:
        with pytest.raises(ValueError):
            czt.czt_fused(*bad)
    assert czt.czt_fused.launches == before


def test_fec_gather_chunk_fills_the_card():
    """The indexed kernel's block walks a whole number of passes, at most
    MAX_CHUNK outputs of one row; one recording spreads its row over every
    SM, and a batch of 1024 at gf3-8192 takes the longest walk."""
    P, M = fec_gather.PASS, fec_gather.MAX_CHUNK
    for B, used in ((1, 235008), (1023, 235008), (1024, 235008),
                    (1024, 9216), (1, 9216), (7, 4608)):
        chunk = fec_gather.fec_gather_chunk(B, used, 132)
        assert chunk % P == 0 and P <= chunk <= M
        blocks = B * -(-used // chunk)
        assert blocks >= 132 or chunk == P
    assert fec_gather.fec_gather_chunk(1024, 235008, 132) == M
    assert fec_gather.fec_gather_chunk(1, 235008, 132) == P


@pytest.mark.parametrize("name", list(FEC_GATHER_CONFIGS)[:3])
def test_fec_gather_tiles_fit_and_fill_the_card(name):
    """The tiled kernel's tile fits its shared memory at every batch, with
    a column pitch of 4 mod 32 (float4 reads, the stores' banks); a batch of
    1024 takes 16 rows a tile, and smaller batches fewer, until the grid
    gives every SM two blocks or one row is left."""
    axes = TModem(FEC_GATHER_CONFIGS[name], device="cpu")._fec_axes
    D, B2, A2 = axes
    cols = -(-A2 // fec_gather.TILE_A)
    for B in (1, 2, 7, 64, 1023, 1024):
        tb = fec_gather.fec_gather_tiles(B, axes, 132)
        pitch = fec_gather.tile_pitch(D, tb)
        assert 1 <= tb <= min(16, B2)
        assert pitch >= tb * D and pitch % 32 == 4
        assert 4 * fec_gather.TILE_A * pitch <= fec_gather.TILE_SMEM
        assert B * cols * -(-B2 // tb) >= 2 * 132 or tb == 1
        if tb < min(16, B2):
            assert B * cols * -(-B2 // (2 * tb)) < 2 * 132
    assert fec_gather.fec_gather_tiles(1024, axes, 132) == min(16, B2)
    # a frame too long for one row of 16 columns in shared memory has no
    # tile, and takes the indexed kernel
    assert fec_gather.fec_gather_tiles(1024, (400, 4, 4), 132) is None


def test_loaded_fec_index_refreshes_the_codeword_table():
    """Loading gf3x's deinterleaver into a Modem also rewrites the FEC
    gather's int32 table from it, so the two cannot disagree, and an entry
    outside the frame is refused there."""
    tm = TModem(GF3_STANDARD, device="cpu")
    want = tm.codeword_index.clone()
    tm.codeword_index.zero_()
    load_reference_tables(tm, {"fec_index": tm.fec_index.numpy()})
    assert torch.equal(tm.codeword_index, want)
    # the kernels trust the table's entries: one past the frame is refused
    bad = tm.fec_index.numpy().copy()
    bad[5] = GF3_STANDARD.raw_bits_per_frame
    with pytest.raises(ValueError):
        load_reference_tables(tm, {"fec_index": bad})


@pytest.mark.parametrize("group", list(chip_smoke.llr_hist_edge_values()))
def test_llr_hist_plain_buckets_edge_values(group):
    """`llr_hist_plain` counts each edge value, and its negation, in the
    bucket gf3x's `_hist16_of` gives it: 2^(k−2) opens bucket k, the float
    below it closes k − 1 (clipped to [0, 15]); ±0 and denormals fall in
    0, the largest float, ±inf and NaN in 15."""
    x = chip_smoke.llr_hist_edge_values()[group]
    row = np.concatenate([x, -x])
    want = np.bincount(np.asarray(JModem._hist16_of(jnp.asarray(row))),
                       minlength=16)
    got = llr_hist.llr_hist_plain(
        torch.as_tensor(row)[None], torch.arange(row.size,
                                                 dtype=torch.int32))
    assert got.dtype == torch.int32 and got.shape == (1, 16)
    assert np.array_equal(got[0].numpy(), want)
    bucket = {"zeros": [0, 0], "denormal": [0], "largest": [15],
              "infinities": [15, 15], "nan": [15, 15],
              "edges": [min(k, 15) for k in range(17)],
              "below_edges": [min(max(k - 1, 0), 15) for k in range(17)]}
    assert np.array_equal(want, np.bincount(bucket[group] * 2, minlength=16))


HIST_CONFIGS = {
    "config5": GF3_STANDARD,
    "gf3-8192": GF3_STANDARD.replace(**chip_smoke.WIDE_BANDS["gf3-8192"]),
    "loaded-cell": "gf3-8192-loaded.b1024-15db-room",
    "uninterleaved": GF3_STANDARD.replace(interleave=False),
}


def _hist_config(name: str):
    cfg = HIST_CONFIGS[name]
    if isinstance(cfg, str):   # the benchmark cell's configuration
        from benchmark import harness
        cfg = harness._configs(harness.load_cell(cfg))[0]
    return cfg


@pytest.mark.parametrize("name", list(HIST_CONFIGS))
def test_llr_hist_sorted_table_counts_gf3x_samples(name):
    """The Modem's sample table is gf3x's every-8th coded-stream position
    (its deinterleaver, or none), sorted, int32; the histogram over it
    equals, row by row, `np.bincount` of gf3x's buckets over gf3x's
    unsorted samples — and so does the Modem's `_payload_bits`."""
    cfg = _hist_config(name)
    tm = TModem(cfg, device="cpu")
    raw = cfg.raw_bits_per_frame
    pos = (np.asarray(j_interleave(cfg, jnp.arange(raw), inverse=True))
           if cfg.interleave else np.arange(raw))[::8]
    table = tm.hist_index
    assert table.dtype == torch.int32 and table.shape == (-(-raw // 8),)
    assert np.array_equal(table.numpy(), np.sort(pos))
    rng = np.random.default_rng(7)
    llr = (rng.standard_normal((3, raw))
           * 10.0 ** rng.uniform(-3, 4, (3, raw))).astype(np.float32)
    got = llr_hist.llr_hist(torch.as_tensor(llr), table)
    for r in range(3):
        want = np.bincount(np.asarray(JModem._hist16_of(
            jnp.asarray(llr[r, pos]))), minlength=16)
        assert np.array_equal(got[r].numpy(), want)
    if cfg.fec == "ldpc" and name != "gf3-8192":
        assert torch.equal(tm._payload_bits(torch.as_tensor(llr))[3], got)


@pytest.mark.parametrize("cfg", [GF3_STANDARD, CONFIG1_LOOPBACK],
                         ids=["ldpc", "no-ldpc"])
def test_loaded_fec_index_refreshes_the_hist_table(cfg):
    """Loading another deinterleaver into a Modem re-derives the
    histogram's sample table from it, with or without LDPC, and an entry
    outside the frame is refused there too."""
    tm = TModem(cfg, device="cpu")
    assert hasattr(tm, "codeword_index") == (cfg.fec == "ldpc")
    new = np.random.default_rng(5).permutation(cfg.raw_bits_per_frame)
    load_reference_tables(tm, {"fec_index": new})
    assert np.array_equal(tm.hist_index.numpy(), np.sort(new[::8]))
    if cfg.fec == "ldpc":
        used = cfg.n_codewords * cfg.ldpc_n
        assert np.array_equal(tm.codeword_index.numpy(), new[:used])
    bad = new.copy()
    bad[8] = -1
    with pytest.raises(ValueError):
        load_reference_tables(tm, {"fec_index": bad})


def test_llr_hist_wrapper_dispatch():
    """A CPU tensor runs the plain version and launches nothing; a tensor
    that is not float32 or 2-D, a table that is not int32, 1-D and
    non-empty, and tensors neither on the CPU nor on a CUDA device are
    refused, with no launch."""
    tm = TModem(GF3_STANDARD, device="cpu")
    idx = tm.hist_index
    llr = torch.randn(2, GF3_STANDARD.raw_bits_per_frame)
    before = llr_hist.llr_hist.launches
    assert torch.equal(llr_hist.llr_hist(llr, idx),
                       llr_hist.llr_hist_plain(llr, idx))
    for bad in ((llr.double(), idx), (llr.half(), idx), (llr[0], idx),
                (llr, idx.long()), (llr, idx[:, None]), (llr, idx[:0]),
                (llr.to("meta"), idx.to("meta")), (llr.to("meta"), idx),
                (llr, idx.to("meta"))):
        with pytest.raises(ValueError):
            llr_hist.llr_hist(*bad)
    assert llr_hist.llr_hist.launches == before


def test_llr_hist_chunk_fills_the_card():
    """A batch whose rows give every SM FILL_BLOCKS blocks counts a row a
    block (a plain store, no zeroing); fewer rows split each row into
    equal chunks of at least MIN_CHUNK samples until the card is full."""
    n8192 = -(-GF3_STANDARD.replace(
        **chip_smoke.WIDE_BANDS["gf3-8192"]).raw_bits_per_frame // 8)
    assert n8192 == 29400
    for B, n in ((1024, n8192), (1023, n8192), (528, n8192), (64, n8192),
                 (1, n8192), (1, 1225), (1024, 1225), (7, 4000)):
        chunk = llr_hist.llr_hist_chunk(B, n, 132)
        chunks = -(-n // chunk)
        assert 1 <= chunk <= n
        assert chunk >= llr_hist.MIN_CHUNK or chunks == 1
        assert (B * chunks >= 132 * llr_hist.FILL_BLOCKS
                or chunks == max(n // llr_hist.MIN_CHUNK, 1))
    assert llr_hist.llr_hist_chunk(1024, n8192, 132) == n8192
    assert llr_hist.llr_hist_chunk(1, n8192, 132) == 2100


def test_cut_symbols_wrapper_dispatch():
    """A CPU tensor runs the plain version and launches nothing; a tensor on
    another device is refused, never silently computed."""
    rng = np.random.default_rng(4)
    rx = torch.as_tensor(rng.standard_normal((2, 4000)).astype(np.float32))
    q = torch.tensor([0, 3], dtype=torch.int32)
    kw = dict(valid=3968, block=128, S=3, n_fft=512, body_off=640,
              sym_len=640, cp=128, sc_off=96)
    before = gather_cut.cut_symbols.launches
    syms, scw = gather_cut.cut_symbols(rx, q, **kw)
    ref_s, ref_w = gather_cut.cut_symbols_plain(rx, q, **kw)
    assert torch.equal(syms, ref_s) and torch.equal(scw, ref_w)
    assert torch.equal(syms[1, 0], rx[1, 3 * 128 + 640 + 128:][:512])
    assert gather_cut.cut_symbols.launches == before
    with pytest.raises(ValueError):
        gather_cut.cut_symbols(rx.to("meta"), q.to("meta"), **kw)


@pytest.mark.parametrize("which", ["fused_eq", "ldpc", "eq_track",
                                   "demap_bins", "ldpc_check", "ldpc_decode"])
def test_other_wrappers_refuse_non_cpu_tensors(which):
    """Kernels 2 and 3 (and each of kernel 3's two passes), and the split
    tail's kernels A and B, likewise refuse a tensor that is neither on the
    CPU nor on a CUDA device, and count no launch."""
    cfg = GF3_STANDARD
    Y = torch.zeros(1, 24, cfg.n_used, dtype=torch.complex64, device="meta")
    H = torch.zeros(1, cfg.n_used, dtype=torch.complex64, device="meta")
    nv = torch.zeros(1, device="meta")
    if which == "fused_eq":
        call = lambda: fused_eq.fused_eq_demap(cfg, Y, H, nv)  # noqa: E731
        fn = fused_eq.fused_eq_demap
    elif which == "eq_track":
        call = lambda: split_eq.eq_track(cfg, Y, H, nv)  # noqa: E731
        fn = split_eq.eq_track
    elif which == "demap_bins":
        tables = [torch.zeros(cfg.n_data_bins, dtype=torch.int32,
                              device="meta")] * 3
        call = lambda: split_eq.demap_bins(  # noqa: E731
            cfg, Y[:, 4:], H, torch.zeros(1, 20, device="meta"), tables)
        fn = split_eq.demap_bins
    elif which == "ldpc_check":
        lam = torch.zeros(4, 24 * 96, device="meta")
        call = lambda: ldpc_bp.minsum_check(lam, 96, "1/2")  # noqa: E731
        fn = ldpc_bp.minsum_check
    elif which == "ldpc_decode":
        lam = torch.zeros(4, 24 * 96, device="meta")
        call = lambda: ldpc_bp.minsum_decode(  # noqa: E731
            lam, lam, lam[:, 0] < 0, torch.zeros(4, dtype=torch.int32,
                                                 device="meta"),
            None, 96, "1/2", 5)
        fn = ldpc_bp.minsum_decode
    else:
        lam = torch.zeros(4, 24 * 96, device="meta")
        call = lambda: ldpc_bp.minsum_totals(lam, 96, "1/2", 5)  # noqa: E731
        fn = ldpc_bp.minsum_totals
    before = fn.launches
    with pytest.raises(ValueError):
        call()
    assert fn.launches == before


def test_kernel_build_recipe():
    """The library is keyed by its sources and flags, built for sm_90a with
    multiply-add contraction off (the LDPC kernel's bit-exactness), and
    loading it is deferred to the first launch."""
    path = device.library_path()
    assert path == device.library_path()
    assert path.parent.parent.name == "_build"
    assert "arch=compute_90a,code=sm_90a" in device.NVCC_FLAGS
    assert "--fmad=false" in device.NVCC_FLAGS
    names = {p.name for p in device.CSRC.iterdir()}
    assert {"cut_symbols.cu", "gather_cut.cu", "cut_dft.cu", "fused_eq.cu",
            "ldpc_bp.cu", "split_eq.cu", "eq_demap.cuh", "binding.cu"} <= names
    assert device.kernel_lib.cache_info().currsize == 0
