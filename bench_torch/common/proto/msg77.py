"""77-bit WSJT-X message payload codec (pack77 / unpack77).

Behavioral reimplementation of the public WSJT-X 77-bit message protocol
(lib/77bit/packjt77.f90, which the reference decoder calls through
reference src/f_interop.cpp:25-29 but whose sources are absent from the
snapshot). The reference only *unpacks* (received messages, nrx=1); we also
implement pack77 because the decoder needs an encoder to synthesize
test fixtures and benchmarks (the demo WAV was stripped from the snapshot).

Message types (i3.n3):
  0.0 free text (13 chars)      0.1 DXpedition        0.2 EU VHF contest
  0.3/0.4 ARRL Field Day        0.5 telemetry (18 hex)
  1 standard (/R)               2 standard (/P, EU VHF)
  3 ARRL RTTY Roundup           4 nonstandard call    5 EU VHF (6-digit grid)

Note: the reference decoder pre-filters plausible types before calling
unpack77 (reference src/decode_softbits.cpp:25-30): only i3 in {1,2,4,5}
and i3=0 with n3 in {0,2,5} ever reach the codec there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

# --- Alphabets ---
A1 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"  # 37
A2 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"  # 36
A3 = "0123456789"  # 10
A4 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"  # 27
A_FREE = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ+-./?"  # 42, free text
A_HASH = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ/"  # 38, hashing & c58

NTOKENS = 2063592
MAX22 = 4194304
MAXGRID4 = 32400

# ARRL RTTY Roundup multipliers (i3=3 s13 field, values 8001+)
RTTY_STATES = (
    "AL AK AZ AR CA CO CT DE FL GA HI ID IL IN IA KS KY LA ME MD MA MI MN MS MO "
    "MT NE NV NH NJ NM NY NC ND OH OK OR PA RI SC SD TN TX UT VT VA WA WV WI WY "
    "NB NS QC ON MB SK AB BC NWT NF LB NU YT PEI DC"
).split()

# ARRL Field Day sections (i3=0, n3=3/4)
FD_SECTIONS = (
    "AB AK AL AR AZ BC CO CT DE EB EMA ENY EPA EWA GA GTA IA ID IL IN KS KY LA "
    "LAX MAR MB MDC ME MI MN MO MS MT NC ND NE NFL NH NL NLI NM NNJ NNY NT NTX "
    "NV OH OK ONE ONN ONS OR ORG PAC PR QC RI SB SC SCV SD SDG SF SFL SJV SK "
    "SNJ STX SV TN TX UT VA VI VT WCF WI WMA WNY WPA WTX WV WWA WY DX"
).split()


def _bits_to_int(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _int_to_bits(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8)


def ihashcall(call: str, m: int) -> int:
    """WSJT-X callsign hash: base-38 fold of 11 chars, multiply, top m bits."""
    c = call.strip().ljust(11)[:11]
    n = 0
    for ch in c:
        j = A_HASH.find(ch)
        if j < 0:
            j = 0
        n = 38 * n + j
    return ((47055833459 * n) & ((1 << 64) - 1)) >> (64 - m)


#: Cap per hash table; WSJT-X keeps the *most recent* call per hash value (the
#: tables are keyed by hash, so collisions overwrite), but its process restarts
#: between sessions while this stream decoder runs indefinitely — bound the
#: table so a years-long busy-band stream cannot grow it without limit.
#: FIFO eviction (oldest heard call goes first) matches the hashing protocol's
#: intent: hashes resolve against *recently heard* callsigns.
HASH_TABLE_MAX = 4096


@dataclass
class CallsignHashTable:
    """Hash -> callsign memory, mirroring WSJT-X save_hash_call semantics."""

    h10: Dict[int, str] = field(default_factory=dict)
    h12: Dict[int, str] = field(default_factory=dict)
    h22: Dict[int, str] = field(default_factory=dict)

    def add(self, call: str) -> None:
        call = call.strip().upper()
        if not call or call.startswith("<"):
            return
        if len(call) < 3 or call in ("CQ", "DE", "QRZ"):
            return
        for table, m in ((self.h10, 10), (self.h12, 12), (self.h22, 22)):
            h = ihashcall(call, m)
            # re-adding a known call refreshes its age (delete + reinsert)
            table.pop(h, None)
            if len(table) >= HASH_TABLE_MAX:
                table.pop(next(iter(table)))
            table[h] = call

    def lookup(self, table: Dict[int, str], h: int) -> str:
        call = table.get(h)
        return f"<{call}>" if call else "<...>"


# ---------------------------------------------------------------------------
# Callsign c28 field
# ---------------------------------------------------------------------------


def _prefix_fold(call: str) -> str:
    """3DA0/3X prefix folding used by the 28-bit packing (protocol quirk)."""
    if call.startswith("3DA0") and 4 < len(call) <= 7:
        return "3D0" + call[4:]
    if call.startswith("3X") and len(call) > 2 and call[2].isalpha() and len(call) <= 7:
        return "Q" + call[2:]
    return call


def _prefix_unfold(call: str) -> str:
    if call.startswith("3D0") and len(call) > 3:
        return "3DA0" + call[3:]
    if call.startswith("Q") and len(call) > 1 and call[1].isalpha():
        return "3X" + call[1:]
    return call


def std_call_to_6(call: str) -> Optional[str]:
    """Align a standard callsign into the canonical 6-char form, or None."""
    call = _prefix_fold(call.strip().upper())
    if not 2 <= len(call) <= 6:
        return None
    for cand in (call.ljust(6), (" " + call).ljust(6)):
        if len(cand) != 6:
            continue
        c = cand
        if (
            c[0] in A1
            and c[1] in A2
            and c[2] in A3
            and all(ch in A4 for ch in c[3:6])
            and c[3:6].rstrip(" ").find(" ") < 0  # no embedded blanks in suffix
            and any(ch.isalpha() for ch in c)
        ):
            return c
    return None


def is_standard_call(call: str) -> bool:
    base = call.upper()
    for suf in ("/R", "/P"):
        if base.endswith(suf):
            base = base[:-2]
    return std_call_to_6(base) is not None


def pack28(call: str, hashes: Optional[CallsignHashTable] = None) -> Optional[int]:
    call = call.strip().upper()
    if call == "DE":
        return 0
    if call == "QRZ":
        return 1
    if call == "CQ":
        return 2
    if call.startswith("CQ ") or call.startswith("CQ_"):
        tail = call[3:].strip()
        if tail.isdigit() and len(tail) == 3:
            return 3 + int(tail)
        if 1 <= len(tail) <= 4 and tail.isalpha():
            n = 0
            for ch in tail.ljust(4):
                n = 27 * n + A4.find(ch)
            return 3 + 1000 + n
        return None
    c6 = std_call_to_6(call)
    if c6 is not None:
        n = A1.find(c6[0])
        n = n * 36 + A2.find(c6[1])
        n = n * 10 + A3.find(c6[2])
        n = n * 27 + A4.find(c6[3])
        n = n * 27 + A4.find(c6[4])
        n = n * 27 + A4.find(c6[5])
        return NTOKENS + MAX22 + n
    # nonstandard: send a 22-bit hash reference
    if call.startswith("<") and call.endswith(">"):
        inner = call[1:-1]
        if hashes is not None:
            hashes.add(inner)
        return NTOKENS + ihashcall(inner, 22)
    return None


def unpack28(n28: int, hashes: CallsignHashTable) -> Tuple[bool, str]:
    if n28 == 0:
        return True, "DE"
    if n28 == 1:
        return True, "QRZ"
    if n28 == 2:
        return True, "CQ"
    if 3 <= n28 <= 1002:
        return True, f"CQ {n28 - 3:03d}"
    if 1003 <= n28 <= 532443:
        n = n28 - 1003
        chars = []
        for _ in range(4):
            chars.append(A4[n % 27])
            n //= 27
        return True, ("CQ " + "".join(reversed(chars)).strip())
    if n28 < NTOKENS:
        return False, ""
    if n28 < NTOKENS + MAX22:
        return True, hashes.lookup(hashes.h22, n28 - NTOKENS)
    n = n28 - NTOKENS - MAX22
    c = [""] * 6
    n, r = divmod(n, 27)
    c[5] = A4[r]
    n, r = divmod(n, 27)
    c[4] = A4[r]
    n, r = divmod(n, 27)
    c[3] = A4[r]
    n, r = divmod(n, 10)
    c[2] = A3[r]
    n, r = divmod(n, 36)
    c[1] = A2[r]
    if n >= 37:
        return False, ""
    c[0] = A1[n]
    call = _prefix_unfold("".join(c).strip())
    if len(call) < 3:
        return False, ""
    return True, call


# ---------------------------------------------------------------------------
# Grid / report g15 field
# ---------------------------------------------------------------------------


def pack_g15(arg: str, ir: int) -> Optional[Tuple[int, int]]:
    """Pack the grid/report argument; returns (igrid15, ir) or None."""
    arg = arg.strip().upper()
    if arg == "" or arg == " ":
        return MAXGRID4 + 1, ir
    if arg == "RRR":
        return MAXGRID4 + 2, ir
    if arg == "RR73":
        return MAXGRID4 + 3, ir
    if arg == "73":
        return MAXGRID4 + 4, ir
    if len(arg) == 4 and arg[0] in "ABCDEFGHIJKLMNOPQR" and arg[1] in "ABCDEFGHIJKLMNOPQR" and arg[2:].isdigit():
        g = (ord(arg[0]) - 65) * 18 + (ord(arg[1]) - 65)
        g = (g * 10 + int(arg[2])) * 10 + int(arg[3])
        return g, ir
    body = arg
    r_flag = ir
    if body.startswith("R") and len(body) >= 3 and body[1] in "+-":
        r_flag = 1
        body = body[1:]
    if body and body[0] in "+-" and body[1:].isdigit():
        rpt = int(body)
        if -30 <= rpt <= 32:
            return MAXGRID4 + 35 + rpt, r_flag
    return None


def unpack_g15(igrid15: int, ir: int) -> Tuple[str, bool]:
    """Return (suffix_text, is_grid). suffix_text includes any R prefix."""
    if igrid15 <= MAXGRID4:
        g = igrid15
        c4 = g % 10
        g //= 10
        c3 = g % 10
        g //= 10
        c2 = g % 18
        c1 = g // 18
        grid = f"{chr(65 + c1)}{chr(65 + c2)}{c3}{c4}"
        return (("R " if ir == 1 else "") + grid), True
    irpt = igrid15 - MAXGRID4
    if irpt == 1:
        return "", False
    if irpt == 2:
        return "RRR", False
    if irpt == 3:
        return "RR73", False
    if irpt == 4:
        return "73", False
    rpt = irpt - 35
    txt = f"{'+' if rpt >= 0 else '-'}{abs(rpt):02d}"
    if ir == 1:
        txt = "R" + txt
    return txt, False


# ---------------------------------------------------------------------------
# 6-character locator g25 field (EU VHF types 0.2 and 5)
# ---------------------------------------------------------------------------


def encode_grid6(grid: str) -> Optional[int]:
    """6-char Maidenhead locator -> 25-bit integer (types 0.2 / 5)."""
    g = grid.strip().upper()
    if (len(g) != 6 or g[0] not in "ABCDEFGHIJKLMNOPQR"
            or g[1] not in "ABCDEFGHIJKLMNOPQR" or not g[2:4].isdigit()
            or g[4] not in "ABCDEFGHIJKLMNOPQRSTUVWX"
            or g[5] not in "ABCDEFGHIJKLMNOPQRSTUVWX"):
        return None
    v = (ord(g[0]) - 65) * 18 + (ord(g[1]) - 65)
    v = v * 10 + int(g[2])
    v = v * 10 + int(g[3])
    v = v * 24 + (ord(g[4]) - 65)
    v = v * 24 + (ord(g[5]) - 65)
    return v


def decode_grid6(igrid6: int) -> Optional[str]:
    g = igrid6
    g6 = g % 24
    g //= 24
    g5 = g % 24
    g //= 24
    d2 = g % 10
    g //= 10
    d1 = g % 10
    g //= 10
    c2 = g % 18
    c1 = g // 18
    if c1 >= 18:
        return None
    return f"{chr(65 + c1)}{chr(65 + c2)}{d1}{d2}{chr(65 + g5)}{chr(65 + g6)}"


def _parse_euvhf_exch(tok: str) -> Optional[Tuple[int, int]]:
    """'590003'-style EU VHF exchange -> (irpt, nserial); report 52..59."""
    if len(tok) != 6 or not tok.isdigit():
        return None
    rs = int(tok[:2])
    if not 52 <= rs <= 59:
        return None
    return rs - 52, int(tok[2:])


# ---------------------------------------------------------------------------
# Free text / telemetry
# ---------------------------------------------------------------------------


def pack_text71(text: str) -> Optional[int]:
    text = text.upper().ljust(13)[:13]
    if any(ch not in A_FREE for ch in text):
        return None
    n = 0
    for ch in text:
        n = n * 42 + A_FREE.find(ch)
    return n


def unpack_text71(n: int) -> str:
    chars = []
    for _ in range(13):
        chars.append(A_FREE[n % 42])
        n //= 42
    return "".join(reversed(chars)).strip()


# ---------------------------------------------------------------------------
# pack77 — text -> 77 bits
# ---------------------------------------------------------------------------


def _compose(*fields: Tuple[int, int]) -> np.ndarray:
    bits = np.concatenate([_int_to_bits(v, n) for v, n in fields])
    assert bits.size == 77, bits.size
    return bits


def pack77(msg: str, hashes: Optional[CallsignHashTable] = None) -> np.ndarray:
    """Pack a message into 77 bits. Raises ValueError if unpackable."""
    hashes = hashes if hashes is not None else CallsignHashTable()
    msg = " ".join(msg.strip().upper().split())
    bits = _try_pack_standard(msg, hashes)
    if bits is None:
        bits = _try_pack_rtty(msg, hashes)
    if bits is None:
        bits = _try_pack_euvhf_02(msg, hashes)
    if bits is None:
        bits = _try_pack_euvhf_5(msg, hashes)
    if bits is None:
        bits = _try_pack_field_day(msg, hashes)
    if bits is None:
        bits = _try_pack_dxpedition(msg, hashes)
    if bits is None:
        bits = _try_pack_nonstd(msg, hashes)
    if bits is None:
        bits = _try_pack_telemetry(msg)
    if bits is None:
        n = pack_text71(msg[:13])
        if n is not None:
            bits = _compose((n, 71), (0, 3), (0, 3))
    if bits is None:
        raise ValueError(f"cannot pack message: {msg!r}")
    return bits


def _split_suffix(call: str) -> Tuple[str, int, int]:
    """Return (base, ip_flag, i3) where i3 is forced by /R or /P suffix."""
    if call.endswith("/R"):
        return call[:-2], 1, 1
    if call.endswith("/P"):
        return call[:-2], 1, 2
    return call, 0, 0


def _try_pack_standard(msg: str, hashes: CallsignHashTable) -> Optional[np.ndarray]:
    toks = msg.split()
    if not toks:
        return None
    # Re-join CQ modifiers: "CQ POTA CALL GRID" -> first token "CQ POTA"
    if toks[0] == "CQ" and len(toks) >= 3 and (toks[1].isdigit() or (toks[1].isalpha() and len(toks[1]) <= 4)):
        if len(toks) >= 3 and is_standard_call(toks[2]):
            toks = [f"CQ {toks[1]}"] + toks[2:]
    if len(toks) < 2 or len(toks) > 4:
        return None
    c1_txt, c2_txt = toks[0], toks[1]
    rest = toks[2:]
    ir = 0
    if rest and rest[0] == "R" and len(rest) == 2:
        ir = 1
        rest = rest[1:]
    if len(rest) > 1:
        return None  # a trailing token the g15 field cannot carry
    arg = rest[0] if rest else ""
    b1, ipa, i3a = _split_suffix(c1_txt)
    b2, ipb, i3b = _split_suffix(c2_txt)
    if i3a and i3b and i3a != i3b:
        return None
    i3 = i3a or i3b or 1
    n28a = pack28(b1, hashes)
    n28b = pack28(b2, hashes)
    if n28a is None or n28b is None:
        return None
    g = pack_g15(arg, ir)
    if g is None:
        return None
    igrid15, ir = g
    hashes.add(b1)
    hashes.add(b2)
    return _compose((n28a, 28), (ipa, 1), (n28b, 28), (ipb, 1), (ir, 1), (igrid15, 15), (i3, 3))


def _try_pack_nonstd(msg: str, hashes: CallsignHashTable) -> Optional[np.ndarray]:
    toks = msg.split()
    if len(toks) < 2 or len(toks) > 3:
        return None
    rpt_map = {"": 0, "RRR": 1, "RR73": 2, "73": 3}
    rpt = toks[2] if len(toks) == 3 else ""
    if rpt not in rpt_map:
        return None
    icq = 1 if toks[0] == "CQ" else 0
    if icq:
        if len(toks) != 2:
            return None
        call3, other = toks[1], ""
        iflip = 0
    else:
        c1, c2 = toks[0], toks[1]
        h1 = c1.startswith("<") and c1.endswith(">")
        h2 = c2.startswith("<") and c2.endswith(">")
        if h1 == h2:
            # exactly one call must be the hashed one; hash the standard call
            if is_standard_call(c1) and not is_standard_call(c2):
                h1 = True
            elif is_standard_call(c2) and not is_standard_call(c1):
                h2 = True
            else:
                return None
        if h1:
            iflip, other, call3 = 0, c1.strip("<>"), c2
        else:
            iflip, other, call3 = 1, c2.strip("<>"), c1
    call3 = call3.strip("<>")
    if not call3 or len(call3) > 11 or any(ch not in A_HASH for ch in call3):
        return None
    n58 = 0
    for ch in call3.rjust(11):
        n58 = n58 * 38 + A_HASH.find(ch)
    if n58 >= 1 << 58:
        return None
    n12 = ihashcall(other, 12) if other else 0
    hashes.add(call3)
    if other:
        hashes.add(other)
    return _compose((n12, 12), (n58, 58), (iflip, 1), (rpt_map[rpt], 2), (icq, 1), (4, 3))


def _try_pack_rtty(msg: str, hashes: CallsignHashTable) -> Optional[np.ndarray]:
    """i3=3 ARRL RTTY Roundup: t1 c28 c28 R1 r3 s13.
    'TU; W9XYZ K1ABC R 579 WI' / 'K1ABC W9XYZ 579 0013'."""
    toks = msg.split()
    itu = 0
    if toks and toks[0] == "TU;":
        itu = 1
        toks = toks[1:]
    if len(toks) not in (4, 5):
        return None
    c1_t, c2_t = toks[0], toks[1]
    rest = toks[2:]
    ir = 0
    if rest[0] == "R":
        if len(rest) != 3:
            return None
        ir = 1
        rest = rest[1:]
    if len(rest) != 2:
        return None
    rst, exch = rest
    if not (len(rst) == 3 and rst[0] == "5" and rst[2] == "9"
            and rst[1] in "23456789"):
        return None
    irpt = int(rst[1]) - 2
    if exch in RTTY_STATES:
        nexch = 8001 + RTTY_STATES.index(exch)
    elif exch.isdigit() and len(exch) == 4 and 0 < int(exch) <= 7999:
        nexch = int(exch)
    else:
        return None
    n28a = pack28(c1_t, hashes)
    n28b = pack28(c2_t, hashes)
    if n28a is None or n28b is None:
        return None
    hashes.add(c1_t)
    hashes.add(c2_t)
    return _compose((itu, 1), (n28a, 28), (n28b, 28), (ir, 1), (irpt, 3),
                    (nexch, 13), (3, 3))


def _try_pack_euvhf_02(msg: str, hashes: CallsignHashTable) -> Optional[np.ndarray]:
    """Type 0.2 EU VHF contest: c28 p1 r1 r3 s11 g25 (69 payload bits).
    'PA3XYZ/P R 590003 IO91NP'."""
    toks = msg.split()
    if len(toks) not in (3, 4):
        return None
    call = toks[0]
    rest = toks[1:]
    ir = 0
    if rest[0] == "R":
        if len(rest) != 3:
            return None
        ir = 1
        rest = rest[1:]
    if len(rest) != 2:
        return None
    exch = _parse_euvhf_exch(rest[0])
    igrid6 = encode_grid6(rest[1])
    if exch is None or igrid6 is None:
        return None
    irpt, nserial = exch
    if nserial >= 1 << 11:
        return None
    ipa = 0
    base = call
    if base.endswith("/P"):
        ipa = 1
        base = base[:-2]
    n28a = pack28(base, hashes)
    if n28a is None:
        return None
    hashes.add(base)
    return _compose((n28a, 28), (ipa, 1), (ir, 1), (irpt, 3), (nserial, 11),
                    (igrid6, 25), (0, 2), (2, 3), (0, 3))


def _try_pack_euvhf_5(msg: str, hashes: CallsignHashTable) -> Optional[np.ndarray]:
    """i3=5 EU VHF contest with 6-char locator: h12 h22 R1 r3 s11 g25.
    '<PA3XYZ> <G4ABC> R 590003 JO22DB'."""
    toks = msg.split()
    if len(toks) not in (4, 5):
        return None
    c1_t, c2_t = toks[0], toks[1]
    rest = toks[2:]
    ir = 0
    if rest[0] == "R":
        if len(rest) != 3:
            return None
        ir = 1
        rest = rest[1:]
    if len(rest) != 2:
        return None
    exch = _parse_euvhf_exch(rest[0])
    igrid6 = encode_grid6(rest[1])
    if exch is None or igrid6 is None:
        return None
    irpt, nserial = exch
    if nserial >= 1 << 11:
        return None
    c1 = c1_t.strip("<>")
    c2 = c2_t.strip("<>")
    if not c1 or not c2:
        return None
    n12 = ihashcall(c1, 12)
    n22 = ihashcall(c2, 22)
    hashes.add(c1)
    hashes.add(c2)
    return _compose((n12, 12), (n22, 22), (ir, 1), (irpt, 3), (nserial, 11),
                    (igrid6, 25), (5, 3))


def _try_pack_field_day(msg: str, hashes: CallsignHashTable) -> Optional[np.ndarray]:
    """Types 0.3/0.4 ARRL Field Day: c28 c28 R1 n4 k3 S7.
    'WA9XYZ KA1ABC R 16A EMA' (n3=3: 1-16 transmitters; n3=4: 17-32)."""
    toks = msg.split()
    if len(toks) not in (4, 5):
        return None
    c1_t, c2_t = toks[0], toks[1]
    rest = toks[2:]
    ir = 0
    if rest[0] == "R":
        if len(rest) != 3:
            return None
        ir = 1
        rest = rest[1:]
    if len(rest) != 2:
        return None
    txcls, sec = rest
    if sec not in FD_SECTIONS:
        return None
    if not (2 <= len(txcls) <= 3 and txcls[:-1].isdigit()
            and txcls[-1] in "ABCDEFGH"):
        return None
    ntx = int(txcls[:-1])
    if not 1 <= ntx <= 32:
        return None
    nclass = ord(txcls[-1]) - ord("A")
    n3 = 3 if ntx <= 16 else 4
    intx = ntx - 1 - (16 if n3 == 4 else 0)
    n28a = pack28(c1_t, hashes)
    n28b = pack28(c2_t, hashes)
    if n28a is None or n28b is None:
        return None
    hashes.add(c1_t)
    hashes.add(c2_t)
    isec = FD_SECTIONS.index(sec) + 1
    return _compose((n28a, 28), (n28b, 28), (ir, 1), (intx, 4), (nclass, 3),
                    (isec, 7), (n3, 3), (0, 3))


def _try_pack_dxpedition(msg: str, hashes: CallsignHashTable) -> Optional[np.ndarray]:
    """Type 0.1 DXpedition: c28 c28 h10 r5.
    'K1ABC RR73; W9XYZ <KH1/KH7Z> -08'."""
    toks = msg.split()
    if len(toks) != 5 or toks[1] != "RR73;":
        return None
    c1_t, c3_t, c2_t, rpt_t = toks[0], toks[2], toks[3], toks[4]
    if not (c2_t.startswith("<") and c2_t.endswith(">")):
        return None
    if not (len(rpt_t) == 3 and rpt_t[0] in "+-" and rpt_t[1:].isdigit()):
        return None
    rpt = int(rpt_t)
    if rpt < -30 or rpt > 32 or (rpt + 30) % 2:
        return None
    n28a = pack28(c1_t, hashes)
    n28b = pack28(c3_t, hashes)
    if n28a is None or n28b is None:
        return None
    c2 = c2_t.strip("<>")
    n10 = ihashcall(c2, 10)
    n5 = (rpt + 30) // 2
    hashes.add(c1_t)
    hashes.add(c3_t)
    hashes.add(c2)
    return _compose((n28a, 28), (n28b, 28), (n10, 10), (n5, 5),
                    (1, 3), (0, 3))


def _try_pack_telemetry(msg: str) -> Optional[np.ndarray]:
    t = msg.strip().upper()
    if not t or len(t) > 18 or any(ch not in "0123456789ABCDEF" for ch in t):
        return None
    if not any(ch.isalpha() for ch in t) and len(t) < 10:
        return None  # short digit strings are better treated as free text
    v = int(t, 16)
    if v >= 1 << 71:
        return None
    return _compose((v, 71), (5, 3), (0, 3))


# ---------------------------------------------------------------------------
# unpack77 — 77 bits -> text
# ---------------------------------------------------------------------------


def unpack77(bits77, hashes: Optional[CallsignHashTable] = None) -> Tuple[bool, str]:
    """Unpack 77 payload bits to message text.

    Returns (success, text). Mirrors WSJT-X unpack77 with nrx=1 (receive side:
    successfully seen callsigns are remembered for later <hash> resolution).
    """
    hashes = hashes if hashes is not None else CallsignHashTable()
    bits = np.asarray(bits77, dtype=np.uint8).reshape(77)
    n3 = _bits_to_int(bits[71:74])
    i3 = _bits_to_int(bits[74:77])

    if i3 == 0 and n3 == 0:
        return True, unpack_text71(_bits_to_int(bits[:71]))
    if i3 == 0 and n3 == 1:
        return _unpack_dxpedition(bits, hashes)
    if i3 == 0 and n3 == 2:
        return _unpack_euvhf_02(bits, hashes)
    if i3 == 0 and n3 in (3, 4):
        return _unpack_field_day(bits, hashes, n3)
    if i3 == 0 and n3 == 5:
        # telemetry displays as 18 hex digits with AT MOST the single
        # leading zero blanked — mirroring WSJT-X's
        # `if(msg(1:1).eq.'0') msg(1:1)=' '` (the reference links that
        # unpack77 via f_interop). A 17-digit string still re-packs as
        # telemetry (>= 10 hex chars), so round-trip identity holds;
        # stripping ALL zeros would re-pack short digit strings as free
        # text — tests/test_protocol.py EDGE_ANSWER pins both properties
        v = _bits_to_int(bits[:71])
        s = f"{v:018X}"
        return True, s[1:] if s[0] == "0" else s
    if i3 in (1, 2):
        return _unpack_standard(bits, hashes, i3)
    if i3 == 3:
        return _unpack_rtty(bits, hashes)
    if i3 == 4:
        return _unpack_nonstd(bits, hashes)
    if i3 == 5:
        return _unpack_euvhf(bits, hashes)
    return False, ""


def _unpack_standard(bits, hashes, i3) -> Tuple[bool, str]:
    n28a = _bits_to_int(bits[0:28])
    ipa = int(bits[28])
    n28b = _bits_to_int(bits[29:57])
    ipb = int(bits[57])
    ir = int(bits[58])
    igrid15 = _bits_to_int(bits[59:74])
    ok1, c1 = unpack28(n28a, hashes)
    ok2, c2 = unpack28(n28b, hashes)
    if not (ok1 and ok2):
        return False, ""
    suf = "/R" if i3 == 1 else "/P"
    if ipa and not c1.startswith(("<", "CQ", "DE", "QRZ")):
        c1 += suf
    if ipb and not c2.startswith(("<", "CQ", "DE", "QRZ")):
        c2 += suf
    for c in (c1, c2):
        if not c.startswith(("<", "CQ", "DE", "QRZ")):
            hashes.add(c.replace("/R", "").replace("/P", ""))
    tail, _ = unpack_g15(igrid15, ir)
    msg = f"{c1} {c2}" + (f" {tail}" if tail else "")
    return True, msg


def _unpack_nonstd(bits, hashes) -> Tuple[bool, str]:
    n12 = _bits_to_int(bits[0:12])
    n58 = _bits_to_int(bits[12:70])
    iflip = int(bits[70])
    nrpt = _bits_to_int(bits[71:73])
    icq = int(bits[73])
    chars = []
    n = n58
    for _ in range(11):
        chars.append(A_HASH[n % 38])
        n //= 38
    call3 = "".join(reversed(chars)).strip()
    if not call3:
        return False, ""
    hashes.add(call3)
    if icq:
        return True, f"CQ {call3}"
    hashed = hashes.lookup(hashes.h12, n12)
    first, second = (hashed, call3) if iflip == 0 else (call3, hashed)
    rpt = {0: "", 1: "RRR", 2: "RR73", 3: "73"}[nrpt]
    msg = f"{first} {second}" + (f" {rpt}" if rpt else "")
    return True, msg


def _unpack_rtty(bits, hashes) -> Tuple[bool, str]:
    itu = int(bits[0])
    n28a = _bits_to_int(bits[1:29])
    n28b = _bits_to_int(bits[29:57])
    ir = int(bits[57])
    irpt = _bits_to_int(bits[58:61])
    nexch = _bits_to_int(bits[61:74])
    ok1, c1 = unpack28(n28a, hashes)
    ok2, c2 = unpack28(n28b, hashes)
    if not (ok1 and ok2):
        return False, ""
    rst = f"5{irpt + 2}9"
    if nexch > 8000:
        idx = nexch - 8001
        if idx >= len(RTTY_STATES):
            return False, ""
        exch = RTTY_STATES[idx]
    else:
        exch = f"{nexch:04d}"
    parts = []
    if itu:
        parts.append("TU;")
    parts += [c1, c2]
    if ir:
        parts.append("R")
    parts += [rst, exch]
    return True, " ".join(parts)


def _unpack_euvhf(bits, hashes) -> Tuple[bool, str]:
    n12 = _bits_to_int(bits[0:12])
    n22 = _bits_to_int(bits[12:34])
    ir = int(bits[34])
    irpt = _bits_to_int(bits[35:38])
    nserial = _bits_to_int(bits[38:49])
    igrid6 = _bits_to_int(bits[49:74])
    c1 = hashes.lookup(hashes.h12, n12)
    c2 = hashes.lookup(hashes.h22, n22)
    grid6 = decode_grid6(igrid6)
    if grid6 is None:
        return False, ""
    exch = f"{52 + irpt}{nserial:04d}"
    parts = [c1, c2]
    if ir:
        parts.append("R")
    parts += [exch, grid6]
    return True, " ".join(parts)


def _unpack_euvhf_02(bits, hashes) -> Tuple[bool, str]:
    """Type 0.2 EU VHF contest: c28 p1 r1 r3 s11 g25 (69 payload bits),
    'PA3XYZ/P R 590003 IO91NP'. The reference's plausibility gate admits it
    (decode_softbits.cpp:29), so a decoder without this branch silently drops
    messages the reference prints."""
    n28a = _bits_to_int(bits[0:28])
    ipa = int(bits[28])
    ir = int(bits[29])
    irpt = _bits_to_int(bits[30:33])
    nserial = _bits_to_int(bits[33:44])
    igrid6 = _bits_to_int(bits[44:69])
    ok1, c1 = unpack28(n28a, hashes)
    if not ok1:
        return False, ""
    if ipa and not c1.startswith(("<", "CQ", "DE", "QRZ")):
        c1 += "/P"
    if not c1.startswith(("<", "CQ", "DE", "QRZ")):
        hashes.add(c1.replace("/P", ""))
    grid6 = decode_grid6(igrid6)
    if grid6 is None:
        return False, ""
    exch = f"{52 + irpt}{nserial:04d}"
    parts = [c1]
    if ir:
        parts.append("R")
    parts += [exch, grid6]
    return True, " ".join(parts)


def _unpack_dxpedition(bits, hashes) -> Tuple[bool, str]:
    n28a = _bits_to_int(bits[0:28])
    n28b = _bits_to_int(bits[28:56])
    n10 = _bits_to_int(bits[56:66])
    n5 = _bits_to_int(bits[66:71])
    ok1, c1 = unpack28(n28a, hashes)
    ok2, c3 = unpack28(n28b, hashes)
    if not (ok1 and ok2):
        return False, ""
    c2 = hashes.lookup(hashes.h10, n10)
    rpt = 2 * n5 - 30
    return True, f"{c1} RR73; {c3} {c2} {'+' if rpt >= 0 else '-'}{abs(rpt):02d}"


def _unpack_field_day(bits, hashes, n3) -> Tuple[bool, str]:
    n28a = _bits_to_int(bits[0:28])
    n28b = _bits_to_int(bits[28:56])
    ir = int(bits[56])
    intx = _bits_to_int(bits[57:61])
    nclass = _bits_to_int(bits[61:64])
    isec = _bits_to_int(bits[64:71])
    ok1, c1 = unpack28(n28a, hashes)
    ok2, c2 = unpack28(n28b, hashes)
    if not (ok1 and ok2) or isec == 0 or isec > len(FD_SECTIONS):
        return False, ""
    ntx = intx + 1 + (16 if n3 == 4 else 0)
    cls = chr(ord("A") + nclass)
    parts = [c1, c2]
    if ir:
        parts.append("R")
    parts.append(f"{ntx}{cls}")
    parts.append(FD_SECTIONS[isec - 1])
    return True, " ".join(parts)


def plausible_message_type(bits77) -> bool:
    """The reference's cheap pre-filter (decode_softbits.cpp:25-30)."""
    bits = np.asarray(bits77).reshape(77)
    n3 = _bits_to_int(bits[71:74])
    i3 = _bits_to_int(bits[74:77])
    if (i3 == 0 and (n3 in (1, 3, 4) or n3 > 5)) or i3 == 3 or i3 > 5:
        return False
    return True
