"""The comparison that decides `correct`.

After the window has closed and the program's state is freed, the plain
reference (reference.py) decodes the windows whose answers the recorder
kept (a uniform sample of the window's windows, drawn from the seed), cut
afresh from the recording, on the path the configuration states (the xb
prefilter's rows, or with `survivor_prefilter` 0 the full demod of every
candidate), and runs its own SNR tracker over every window the stream
carried before them. The numbers compared, each against the
cell's limit in `limits/<workload>.json`:

  unanswered    windows handed to the entry that it never answered
  lines_differ  of the sampled windows' decode lines (every field but the
                date), the share that only one side printed
  xb_gap        over the decoded rows both sides found (`row_key`: same
                frequency, pattern and lag), the widest gap of the scan's
                sync metric xb, relative to the reference's
  rows_differ   of the decoded rows of the sampled windows (by `row_key`),
                the share that only one side found

`lines_differ` is the answers themselves; `xb_gap` is the one that tells a
lower precision on the device path from float32. A number the limits file
does not name (`rows_differ` so far) is printed and not held.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List

import numpy as np

from . import reference as R
from .generator import Recording
from .proto import constants as C
from .proto import msg77

BLOCK = 64  # windows per reference batch


def program_lines(items) -> List[str]:
    return sorted(R.line_text(it.snr, it.f0, it.num_avg, it.nbadsync, it.pattern_idx,
                              it.message) for it in items)


def stream_snr(powers: np.ndarray, last: int) -> np.ndarray:
    """The SNR (truncated dB) the tracker reports after each window 0..last
    of the stream, window i being the recording's window i mod hops."""
    # one window's mean as the tracker takes it: a float64 mean of 8 values
    avg = [float(np.asarray(p, dtype=np.float64).mean()) for p in powers]
    peak = [float(np.asarray(p, dtype=np.float64).max()) for p in powers]
    hops = len(powers)
    tracker = R.SNRTracker()
    out = np.empty(last + 1, dtype=np.int64)
    for i in range(last + 1):
        k = i % hops
        out[i] = tracker.update_from(avg[k], peak[k])
    return out


def row_key(settings: R.Settings, cand: int, pos: int) -> tuple:
    """A decoded row's (frequency, pattern, lag): its candidate index (flat
    into the (F, P, k) grid on both paths) less its rank in the scan cell,
    and its lag modulo the shift of whole frames
    that leaves its pattern's sum unchanged (a frame for the all-frames
    pattern, whose slices tie by construction)."""
    f, rem = divmod(cand, settings.scan_depth * settings.candidates_per_pattern)
    p = rem // settings.candidates_per_pattern
    mask = C.PATTERN_MASKS[p]
    d = next(d for d in range(1, C.NUM_FRAMES + 1) if np.array_equal(np.roll(mask, d), mask))
    return f, p, pos % (d * C.FRAME_LEN)


def keyed_rows(settings: R.Settings, cand, pos, xb) -> Dict[tuple, float]:
    rows: Dict[tuple, float] = {}
    for c, p, x in zip(cand, pos, xb):
        k = row_key(settings, int(c), int(p))
        rows[k] = max(rows.get(k, -np.inf), float(x))
    return rows


def compare(rec: Recording, settings: R.Settings, kept, device) -> Dict:
    """The numbers of the comparison (without `unanswered`, which the
    harness counts) and what they were read from."""
    t0 = time.perf_counter()
    ref = R.ReferenceDecoder(settings, device)
    hops = rec.hops
    powers = np.concatenate([ref.powers(np.stack([rec.window(i) for i in range(s, min(s + 1024, hops))]))
                             for s in range(0, hops, 1024)])
    kept = sorted(kept, key=lambda a: a.window)
    snr = stream_snr(powers, kept[-1].window if kept else 0)
    hashes = msg77.CallsignHashTable()
    only = both = 0
    rows_only = rows_both = 0
    row_examples: List[list] = []  # rows only one side found: (side, window, f0, pattern, lag, xb)
    gaps: List[float] = []
    examples: List[list] = []  # lines that only one side printed: (side, window, line)
    updates = 0
    for s in range(0, len(kept), BLOCK):
        batch = kept[s: s + BLOCK]
        rows = ref.decode(np.stack([rec.window(a.window) for a in batch]))
        updates += int(rows.bp_updates.sum())
        for b, a in enumerate(batch):
            mine = Counter(program_lines(a.items))
            theirs = Counter(R.window_lines(settings, rows, b, int(snr[a.window]), hashes))
            common = sum((mine & theirs).values())
            both += common
            only += sum(mine.values()) + sum(theirs.values()) - 2 * common
            if len(examples) < 6:
                examples += [["program", a.window, x] for x in (mine - theirs).elements()]
                examples += [["reference", a.window, x] for x in (theirs - mine).elements()]
            f = rows.found[b]
            ref_rows = keyed_rows(settings, rows.cand_index[b][f], rows.pos[b][f], rows.xb[b][f])
            prog_rows = keyed_rows(settings, a.cand_index, a.pos, a.xb)
            keys = ref_rows.keys() & prog_rows.keys()
            rows_both += len(keys)
            for side, mine in (("program", prog_rows), ("reference", ref_rows)):
                one = mine.keys() - keys
                rows_only += len(one)
                row_examples += [[side, a.window, float(settings.freqs[k[0]]), k[1], k[2], mine[k]]
                                 for k in sorted(one)[: max(0, 6 - len(row_examples))]]
            gaps += [abs(prog_rows[k] - ref_rows[k]) / max(abs(ref_rows[k]), 1e-30) for k in keys]
    lines = 2 * both + only
    rows_all = 2 * rows_both + rows_only
    return dict(
        lines_differ=only / lines if lines else None,
        xb_gap=max(gaps) if gaps else None,
        rows_differ=rows_only / rows_all if rows_all else None,
        info=dict(windows_compared=len(kept), lines=lines, lines_only_one_side=only,
                  rows_found_both=rows_both, rows_found_one_side=rows_only,
                  rows_one_side_examples=row_examples,
                  bp_updates_per_window=updates / max(len(kept), 1),
                  one_side_examples=examples[:6],
                  reference_s=time.perf_counter() - t0))
