"""The port's host post-processing, on the CPU: `StreamDecoder._postprocess_one`
groups a window's decoded rows by packed payload (one memo lookup per payload,
one `put_message` per message text) and must give what a lookup and a
`put_message` per row gave. `row_by_row` below is that per-row loop, kept as
the reference: the same items, field by field but the date stamp, the same
memo (keys, order, contents), the same `unpack77` calls in the same order (so
the same callsign hash table), the same warnings and the same counters.
Also: the packed bytes the pipeline fetches are `np.packbits` of the payload,
pad bits zero, so they key the memo as the 77 bits did."""

import contextlib
import io

import numpy as np
import pytest
import torch

from msk144cudecoder_tpu_torch import constants as C
from msk144cudecoder_tpu_torch.config import DecoderConfig
from msk144cudecoder_tpu_torch.ops import pipeline
from msk144cudecoder_tpu_torch.ops.pipeline import WindowDecodeResult
from msk144cudecoder_tpu_torch.protocol import msg77
from msk144cudecoder_tpu_torch.runtime import StreamDecoder, decoder, metrics

CFG = DecoderConfig(search_width=20.0, scan_depth=4, max_survivors=8, max_results=8)
R = 8  # rows a window

TEXTS = ["CQ K1ABC FN42", "K1ABC W9XYZ EN37", "W9XYZ K1ABC R-09", "CQ PJ4/K1ABC",
         "<PJ4/K1ABC> W9XYZ", "CQ DX G4ABC IO91"]


def packed(bits77) -> np.ndarray:
    """77 bits -> the 10 bytes the pipeline fetches."""
    return pipeline.pack_message_bits(torch.as_tensor(np.asarray(bits77))).numpy()


def payload(text: str) -> np.ndarray:
    return packed(msg77.pack77(text, msg77.CallsignHashTable()))


def implausible(rng) -> np.ndarray:
    bits = rng.integers(0, 2, 77).astype(np.int8)
    bits[74:77] = (0, 1, 1)  # i3 = 3: plausible_message_type refuses it
    assert not msg77.plausible_message_type(bits)
    return packed(bits)


def row_by_row(dec, res, b):
    """The per-row post-processing the grouping replaced: (items, lookups,
    memo hits)."""
    n_surv = int(res.num_survivors[b])
    dec._warn_overflow(n_surv if n_surv > dec.survivor_capacity else 0,
                       int(res.shard_survivors[b]))
    dec.snr_tracker.process_powers(res.block_power[b])
    dec.result_filter.block_begin()
    rows = np.nonzero(np.asarray(res.found[b]))[0]
    hits = 0
    for k in rows:
        bits77 = pipeline.unpack_message_bits(res.message_bits[b][k])
        key = np.packbits(bits77).tobytes()
        out = dec._decode_cache.get(key)
        if out is not None:
            hits += 1
        else:
            if msg77.plausible_message_type(bits77):
                out = msg77.unpack77(bits77, dec.hashes)
            else:
                out = (False, "")
            if len(dec._decode_cache) >= decoder.DECODE_CACHE_MAX:
                dec._decode_cache.pop(next(iter(dec._decode_cache)))
            dec._decode_cache[key] = out
        ok, text = out
        if not ok:
            continue
        fi, pi, _ = pipeline.unpack_candidate_index(dec.cfg, int(res.cand_index[b][k]))
        dec.result_filter.put_message(
            snr=dec.snr_tracker.snr_i, f0=float(dec._freqs[fi]),
            num_avg=int(C.PATTERN_NUM_AVG[pi]), nbadsync=int(res.nbadsync[b][k]),
            pattern_idx=pi, message=text)
    dec.result_filter.block_end()
    return dec.result_filter.block_result(), len(rows), hits


def result(windows, surv=None):
    """A WindowDecodeResult of windows, each a list of (payload bytes, pattern,
    frequency index, nbadsync) rows, found, padded to R rows with rows not
    found; surv: per window (num_survivors, shard_survivors)."""
    b = len(windows)
    per_f = CFG.scan_depth * CFG.candidates_per_pattern
    cand = np.zeros((b, R), np.int32)
    found = np.zeros((b, R), bool)
    bits = np.zeros((b, R, 10), np.uint8)
    nbad = np.zeros((b, R), np.int32)
    for w, rows in enumerate(windows):
        for k, (p, pi, fi, nb) in enumerate(rows):
            cand[w, k] = fi * per_f + pi * CFG.candidates_per_pattern + k % CFG.candidates_per_pattern
            found[w, k], bits[w, k], nbad[w, k] = True, p, nb
        bits[w, len(rows):] = 0xA5  # rows not found carry garbage
    surv = np.array(surv or [(0, 0)] * b, np.int32).reshape(b, 2)
    rng = np.random.default_rng(b)
    return WindowDecodeResult(
        cand_index=cand, valid=found.copy(), found=found, message_bits=bits, nbadsync=nbad,
        xb=np.zeros((b, R), np.float32), pos=np.zeros((b, R), np.int32),
        ldpc_iterations=np.zeros((b, R), np.int32), hard_errors=np.zeros((b, R), np.int32),
        num_survivors=surv[:, 0].copy(), shard_survivors=surv[:, 1].copy(),
        block_power=rng.uniform(1.0, 50.0, (b, 8)).astype(np.float32))


def random_windows(rng, n_windows, pool):
    return [[(pool[rng.integers(len(pool))], int(rng.integers(CFG.scan_depth)),
              int(rng.integers(len(CFG.freqs))), int(rng.integers(3)))
             for _ in range(rng.integers(0, R + 1))] for _ in range(n_windows)]


def scenario(name):
    """(windows, per-window survivors, memo entries to seed, memo cap)."""
    rng = np.random.default_rng(7)
    p = {t: payload(t) for t in TEXTS}
    bad = implausible(rng)
    twin = implausible(rng)  # seeded into the memo as a second payload of TEXTS[0]
    seed = {twin.tobytes(): (True, TEXTS[0])}
    if name == "repeats":
        return [[(p[TEXTS[0]], 0, 3, 1), (p[TEXTS[1]], 1, 2, 0), (p[TEXTS[0]], 0, 4, 0),
                 (p[TEXTS[0]], 2, 5, 0), (p[TEXTS[1]], 1, 1, 0)]], None, {}, None
    if name == "twin_text":  # two payloads, one text: the better row wins
        return [[(p[TEXTS[0]], 1, 3, 0), (twin, 0, 6, 1), (p[TEXTS[0]], 0, 2, 2),
                 (twin, 0, 7, 1)]], None, seed, None
    if name == "implausible":
        return [[(bad, 0, 1, 0), (p[TEXTS[2]], 0, 2, 0), (bad, 0, 3, 0)]], None, {}, None
    if name == "ties":  # equal (num_avg, nbadsync): the earliest row wins
        return [[(p[TEXTS[1]], 1, 8, 1), (twin, 1, 4, 1), (p[TEXTS[1]], 1, 2, 1),
                 (twin, 1, 9, 1), (p[TEXTS[0]], 1, 1, 1)],
                # across payloads: the later payload's row comes first
                [(twin, 3, 0, 0), (p[TEXTS[0]], 1, 5, 1), (twin, 1, 6, 1)]], None, seed, None
    if name == "zero_rows":
        return [[], [(p[TEXTS[3]], 0, 0, 0)], []], None, {}, None
    if name == "overflow":  # a shard's bound, an aggregate, the global bound
        return ([[(p[TEXTS[0]], 0, 0, 0)], [], [(p[TEXTS[1]], 1, 1, 0)], []],
                [(0, 10), (0, 0), (9, 9), (0, 0)], {}, None)
    if name == "hash_order":  # a hashed call resolves only after its full form unpacks
        return [[(p[TEXTS[4]], 0, 1, 0), (p[TEXTS[3]], 0, 2, 0), (p[TEXTS[4]], 1, 3, 0)],
                [(p[TEXTS[4]], 0, 1, 0), (p[TEXTS[3]], 1, 2, 0)]], None, {}, None
    if name == "fifo_in_window":  # the memo's oldest payload leaves it mid-window
        return [[(p[TEXTS[0]], 0, 0, 0), (p[TEXTS[1]], 0, 1, 0)],
                [(p[TEXTS[0]], 0, 2, 0), (p[TEXTS[2]], 0, 3, 0), (p[TEXTS[0]], 1, 4, 0),
                 (p[TEXTS[5]], 0, 5, 0), (p[TEXTS[1]], 0, 6, 0)]], None, {}, 2
    if name == "random":
        pool = [p[t] for t in TEXTS] + [bad, twin]
        return random_windows(rng, 24, pool), None, seed, 5
    raise KeyError(name)


SCENARIOS = ["repeats", "twin_text", "implausible", "ties", "zero_rows", "overflow",
             "hash_order", "fifo_in_window", "random"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_grouped_postprocess_equals_row_by_row(name, monkeypatch):
    windows, surv, seed, cap = scenario(name)
    if cap is not None:
        monkeypatch.setattr(decoder, "DECODE_CACHE_MAX", cap)
    monkeypatch.setattr(StreamDecoder, "OVERFLOW_WARN_EVERY", 2)
    res = result(windows, surv)
    calls = []
    unpack77 = msg77.unpack77

    def recorded(bits77, hashes=None):
        calls.append(np.packbits(bits77).tobytes())
        return unpack77(bits77, hashes)

    monkeypatch.setattr(msg77, "unpack77", recorded)
    ref, new = StreamDecoder(CFG, "cpu"), StreamDecoder(CFG, "cpu")
    for dec in (ref, new):
        dec._decode_cache.update(seed)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        want = [row_by_row(ref, res, b) for b in range(len(windows))]
    ref_calls, ref_err = calls[:], err.getvalue()
    calls.clear()
    monkeypatch.setenv(metrics.ENV, "1")
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            got = new.postprocess_batch(res, len(windows))
        counters = metrics.recorder().counters
    finally:
        monkeypatch.setenv(metrics.ENV, "0")
        metrics.refresh()

    def fields(items):
        return [(i.snr, i.f0, i.num_avg, i.nbadsync, i.pattern_idx, i.message) for i in items]

    assert [fields(items) for items in got] == [fields(items) for items, _, _ in want]
    assert any(got), "a scenario that decodes nothing checks nothing"
    assert calls == ref_calls
    assert list(new._decode_cache.items()) == list(ref._decode_cache.items())
    assert (new.hashes.h10, new.hashes.h12, new.hashes.h22) == (
        ref.hashes.h10, ref.hashes.h12, ref.hashes.h22)
    warnings = [line for line in err.getvalue().splitlines(True) if "Measured time" not in line]
    assert "".join(warnings) == ref_err  # the spans print with the switch on
    assert new.snr_tracker.snr_i == ref.snr_tracker.snr_i
    assert counters.get("unpack_lookups", 0) == sum(n for _, n, _ in want)
    assert counters.get("memo_hits", 0) == sum(h for _, _, h in want)
    distinct = sum(len({bytes(p) for p, *_ in rows}) for rows in windows)
    assert counters.get("unpack_payloads", 0) == distinct
    if name == "overflow":
        assert "10 sync survivors in one frequency shard" in ref_err
        assert "1 of the last 2 windows" in ref_err and "9 sync survivors exceed" in ref_err
    if name == "fifo_in_window":
        assert len(ref_calls) > len(set(ref_calls))  # a payload unpacked twice in one window


def test_packed_bytes_are_packbits_with_zero_pad():
    """pack_message_bits leaves the 3 pad bits zero, so a fetched row's bytes
    are np.packbits of its 77 bits: the memo key of the per-row loop."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (64, 77)).astype(np.int8)
    rows = packed(bits)
    assert rows.dtype == np.uint8 and rows.shape == (64, 10)
    assert not (rows[:, -1] & 0b111).any()
    np.testing.assert_array_equal(pipeline.unpack_message_bits(rows), bits)
    for row in rows:
        assert row.tobytes() == np.packbits(pipeline.unpack_message_bits(row)).tobytes()


def test_unpack_cached_keys_the_memo_by_packed_bytes():
    dec = StreamDecoder(CFG, "cpu")
    bits = msg77.pack77(TEXTS[0], msg77.CallsignHashTable())
    assert dec._lookup(np.packbits(bits).tobytes()) == (True, TEXTS[0])
    assert list(dec._decode_cache) == [payload(TEXTS[0]).tobytes()]
    assert dec._lookup(payload(TEXTS[0]).tobytes()) == (True, TEXTS[0]) and dec._memo_hits == 1
