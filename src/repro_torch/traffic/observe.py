"""In-loop observability plane for the streaming engine (paper §4.1).

The port of ``repro.traffic.observe``.  The ECI paper's debugging toolkit
captures EWF traces and checks NFA protocol specs online, at the link's
line rate; here it runs inside ``run_stream``'s step loop, on the
device, with no host synchronisation:

* **EWF capture** — a bounded device ring of packed EWF v2 words (int64
  tensors with the reference's uint64 bits), fed from the step's five
  wire-event sites (``core.engine_mn.StepEvents``), overwrite-oldest,
  with per-line and per-msg-type filter masks.  After the run the ring
  exports into ``core.tracing.TraceBuffer`` (the step number rides in
  the txn field).
* **Online NFA checking** — ``core.tracing.compile_spec`` lowers each
  ``NFASpec`` to a dense powerset table; the per-line state SET is a
  bitmask folded with one table gather per event site.  A violating
  transition resyncs the line and latches the first (step, line,
  symbol, states-before) counterexample, as the host-side
  ``check_trace`` reports it.
* **Phase attribution** — per-transaction timestamps fold into latency
  histograms of four phases: ``queue`` (issue window -> engine accept),
  ``service`` (accept -> retire), ``home`` (request parked -> grant) and
  ``fanout`` (park -> last downgrade reply), with a Chrome/Perfetto
  trace-event export.

The ring append is one compacted write per step across all sites: a
cumsum over the candidate lanes, a ``searchsorted`` inversion of it onto
a ``port``-wide window (the trace port's words per step) and one
``port``-wide scatter.  Same-step symbol pairs (mixed ACK/DATA_DIRTY
fan-out replies, the two downgrade flavours) use composite table
columns precompiled by ``_encoded_tables``.

Where the port differs from the reference: the reference skips the
whole fold behind ``lax.cond`` on "any event this step"; a host ``if``
on a device flag would synchronise every step, so the port runs the
fold every step, and with no event present it changes nothing.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Dict, FrozenSet, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import transport as tp
from ..core.engine_mn import StepEvents
from ..core.messages import MsgType
from ..core.tracing import (N_SYMBOLS, SPECS, CompiledSpec, TraceBuffer,
                            compile_spec, symbol_id, symbol_id_name)
from .counters import LAT_EDGES, N_LAT_BUCKETS

#: Attribution phase rows of ``phase_hist`` (shared LAT_EDGES buckets).
PHASES = ("queue", "service", "home", "fanout")
N_PHASES = len(PHASES)

#: Default online spec set: the two invariants every full-protocol stream
#: must satisfy (``readonly`` holds only on READ_ONLY-subset streams).
DEFAULT_SPECS = ("req_resp", "single_writer")

#: Same-step symbol PAIRS that can hit one line together at one site and
#: get composite table columns: mixed fan-out replies, the two voluntary
#: and the two home downgrade flavours.
SYMBOL_PAIRS = (
    (symbol_id(int(MsgType.RESP_DATA_DIRTY), hresp=True),
     symbol_id(int(MsgType.RESP_ACK), hresp=True)),
    (symbol_id(int(MsgType.VOL_DOWNGRADE_S)),
     symbol_id(int(MsgType.VOL_DOWNGRADE_I))),
    (symbol_id(int(MsgType.HOME_DOWNGRADE_S)),
     symbol_id(int(MsgType.HOME_DOWNGRADE_I))),
)
N_COLS = N_SYMBOLS + len(SYMBOL_PAIRS)

_DD = int(MsgType.RESP_DATA_DIRTY)


class ObserveConfig(NamedTuple):
    """Observability switchboard.

    ``capture``/``capacity``: EWF ring on/off and its bound (words).
    ``specs``: names from ``core.tracing.SPECS`` to check online.
    ``attribution``: per-transaction phase histograms on/off.
    ``port``: trace-port bandwidth, the most words captured per STEP
    (events beyond it in one step are dropped and counted).
    ``inject``: optional (step, line, msg_type), a synthetic request word
    spliced into the request site at that step, to exercise the
    checker's counterexample path end to end.
    """

    capture: bool = True
    capacity: int = 1 << 12
    specs: Tuple[str, ...] = DEFAULT_SPECS
    attribution: bool = True
    port: int = 256
    inject: Optional[Tuple[int, int, int]] = None


class ObsCarry(NamedTuple):
    """Loop-carried observability state, on the device; a disabled
    feature carries ``None``."""

    ring: Optional[torch.Tensor]   # [CAP + 1] int64 EWF words; slot CAP
    #                                is the scratch slot of unused lanes
    ring_pos: torch.Tensor      # [] int64 words captured (total, unwrapped)
    ring_dropped: torch.Tensor  # [] int64 words lost to the port cap
    nfa_mask: torch.Tensor      # [n_specs, L] int64 per-line state bitmask
    viol_found: torch.Tensor    # [n_specs] bool counterexample latched
    viol_step: torch.Tensor     # [n_specs] int64
    viol_line: torch.Tensor     # [n_specs] int64
    viol_sym: torch.Tensor      # [n_specs] int64 online symbol id
    viol_mask: torch.Tensor     # [n_specs] int64 states before the event
    acc_step: Optional[torch.Tensor]    # [R, L] int32 engine-accept step
    park_step: Optional[torch.Tensor]   # [L] int32 request-park step
    park_hd: Optional[torch.Tensor]     # [L] bool parked txn fanned out
    last_reply: Optional[torch.Tensor]  # [L] int32 newest fan-out reply
    phase_hist: Optional[torch.Tensor]  # [N_PHASES, N_LAT_BUCKETS] int64


def compiled_specs(names: Tuple[str, ...]) -> Tuple[CompiledSpec, ...]:
    unknown = [n for n in names if n not in SPECS]
    if unknown:
        raise ValueError(f"unknown specs {unknown}; have {sorted(SPECS)}")
    return tuple(compile_spec(SPECS[n]) for n in names)


def _reachable_masks(c: CompiledSpec) -> set:
    """State-set bitmasks reachable from start under resync semantics."""
    seen, frontier = {c.start_mask}, [c.start_mask]
    while frontier:
        m = frontier.pop()
        for s in range(N_SYMBOLS):
            nm = int(c.table[m, s]) or c.start_mask
            if nm not in seen:
                seen.add(nm)
                frontier.append(nm)
    return seen


def _encoded_tables(comp: Tuple[CompiledSpec, ...]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-spec tables into the ENCODED online form.

    Entry layout (int32): bits [0:16) = next state-set mask with
    resync-on-violation applied; bits [16:) = 1 + the violating symbol
    id, or 0 if the transition is clean, so one gather yields the next
    mask AND the counterexample symbol.  Columns [0, N_SYMBOLS) are the
    single symbols; columns [N_SYMBOLS, N_COLS) the ``SYMBOL_PAIRS``
    composites (first symbol applied first); each pair must COMMUTE on
    every reachable mask (final mask and verdict), so the composite
    agrees with any order the host-side checker replays the pair in."""
    if not comp:        # checking disabled: zero-spec tables
        return (np.zeros((0, 1, N_COLS), np.int32),
                np.zeros((0,), np.int32))
    rows = max(c.table.shape[0] for c in comp)
    tab = np.zeros((len(comp), rows, N_COLS), np.int32)
    for i, c in enumerate(comp):
        n = c.table.shape[0]
        raw = c.table.astype(np.int64)                 # [n, N_SYMBOLS]
        sym = np.arange(N_SYMBOLS, dtype=np.int64)[None, :]
        tab[i, :n, :N_SYMBOLS] = np.where(
            raw == 0, c.start_mask | ((sym + 1) << 16), raw)

        def step1(m, s):
            """(next_mask_resynced, violated?) for one symbol on spec i."""
            nm = int(c.table[m, s])
            return (c.start_mask, True) if nm == 0 else (nm, False)

        reach = _reachable_masks(c)
        for pi, (a, b) in enumerate(SYMBOL_PAIRS):
            for m in range(n):
                m1, va = step1(m, a)
                m2, vb = step1(m1, b)
                first = a if va else b
                tab[i, m, N_SYMBOLS + pi] = m2 | (
                    ((first + 1) << 16) if (va or vb) else 0)
                if m in reach:
                    m1r, vb2 = step1(m, b)
                    m2r, va2 = step1(m1r, a)
                    if (m2r, va2 or vb2) != (m2, va or vb):
                        raise ValueError(
                            f"spec '{c.name}': symbol pair "
                            f"({symbol_id_name(a)}, {symbol_id_name(b)}) "
                            f"does not commute on state set "
                            f"{sorted(c.mask_states(m))} — the composite "
                            f"column cannot represent host-side "
                            f"interleavings")
    start = np.asarray([c.start_mask for c in comp], np.int32)
    return tab, start


def obs_tables(comp: Tuple[CompiledSpec, ...], device) -> torch.Tensor:
    """The encoded tables ([n_specs, rows, N_COLS], int64) on ``device``."""
    return torch.as_tensor(_encoded_tables(comp)[0],
                           dtype=torch.int64).to(device)


def make_obs_carry(cfg: ObserveConfig, n_remotes: int, n_lines: int,
                   comp: Tuple[CompiledSpec, ...], device) -> ObsCarry:
    R, L = n_remotes, n_lines
    n = len(comp)

    def z(shape, dt=torch.int64):
        return torch.zeros(shape, dtype=dt, device=device)

    attr = cfg.attribution
    return ObsCarry(
        ring=z(cfg.capacity + 1) if cfg.capture else None,
        ring_pos=z(()), ring_dropped=z(()),
        nfa_mask=torch.tensor([c.start_mask for c in comp],
                              dtype=torch.int64, device=device)[:, None]
        .expand(n, L).contiguous(),
        viol_found=z(n, torch.bool), viol_step=z(n), viol_line=z(n),
        viol_sym=z(n), viol_mask=z(n),
        acc_step=z((R, L), torch.int32) if attr else None,
        park_step=z(L, torch.int32) if attr else None,
        park_hd=z(L, torch.bool) if attr else None,
        last_reply=z(L, torch.int32) if attr else None,
        phase_hist=z((N_PHASES, N_LAT_BUCKETS)) if attr else None)


# ---------------------------------------------------------------------------
# In-loop primitives (device tensors; no host synchronisation).
# ---------------------------------------------------------------------------


class _Consts(NamedTuple):
    """Per-(R, L, port, device) constants of the fold, built once."""

    lines: torch.Tensor     # [L] int64
    base_rl: Dict[int, torch.Tensor]   # class -> [R, L] int64 word bits
    base_l: Dict[int, torch.Tensor]    # class -> [L] int64 word bits
    window: torch.Tensor    # [port] int64
    lat_edges: torch.Tensor  # LAT_EDGES, int32 (as the steps it buckets)
    lat_ids: torch.Tensor   # [N_LAT_BUCKETS] int64


@functools.lru_cache(maxsize=None)
def _consts(R: int, L: int, port: int, device: str) -> _Consts:
    """The word bits fixed by a lane's position: its VC (class * 2 + line
    parity), line and, on the per-remote sites, node (the row)."""
    lines = torch.arange(L, dtype=torch.int64, device=device)
    rows = torch.arange(R, dtype=torch.int64, device=device)[:, None]
    classes = (tp.CLASS_REMOTE_REQ, tp.CLASS_HOME_RESP, tp.CLASS_HOME_REQ,
               tp.CLASS_REMOTE_RESP)
    base_l = {k: (((k * 2 + (lines & 1)) << 4) | (lines << 16))
              for k in classes}
    return _Consts(
        lines=lines,
        base_rl={k: base_l[k][None, :] | (rows << 10) for k in classes},
        base_l=base_l,
        window=torch.arange(port, dtype=torch.int64, device=device),
        lat_edges=torch.as_tensor(LAT_EDGES, dtype=torch.int32)
        .to(device),
        lat_ids=torch.arange(N_LAT_BUCKETS, device=device))


def _step_bits(t: int) -> int:
    """The step number in the txn field [48:64), as an int64 value."""
    v = (t & 0xFFFF) << 48
    return v - (1 << 64) if v >> 63 else v


def _ring_append(oc: ObsCarry, keep: torch.Tensor, words: torch.Tensor,
                 t: int, c: _Consts, cap: int) -> ObsCarry:
    """One compacted overwrite-oldest append of the kept lanes (in lane
    order): a cumsum, its ``searchsorted`` inversion onto the
    ``port``-wide window, and one ``port``-wide scatter.  Lanes past the
    port bandwidth are dropped and counted.  Of more than ``cap`` words
    in one step the last ``cap`` land, each slot written once; the ring
    is written in place, and lanes that do not land write the scratch
    slot ``cap``."""
    n, port = keep.shape[0], c.window.shape[0]
    cum = torch.cumsum(keep, 0)
    total = cum[-1]
    j = c.window
    lane = torch.clamp(torch.searchsorted(cum, j + 1), max=n - 1)
    land = (j < total) & (j >= torch.clamp(total, max=port) - cap)
    slot = torch.where(land, (oc.ring_pos + j) % cap, cap)
    oc.ring.index_put_((slot,), words[lane] | _step_bits(t))
    return oc._replace(
        ring_pos=oc.ring_pos + torch.clamp(total, max=port),
        ring_dropped=oc.ring_dropped + torch.clamp(total - port, min=0))


def _hist_add(rows: torch.Tensor, masks: torch.Tensor, dts: torch.Tensor,
              c: _Consts) -> torch.Tensor:
    """Fold stacked masked latency samples ([k, ...] masks and steps)
    into histogram rows [k, N_LAT_BUCKETS]."""
    k = masks.shape[0]
    bucket = torch.bucketize(dts, c.lat_edges, right=True)
    onehot = (bucket[..., None] == c.lat_ids) & masks[..., None]
    return rows + onehot.reshape(k, -1, N_LAT_BUCKETS).sum(1)


class _Checker:
    """One step's worth of NFA folding over the encoded spec tables."""

    def __init__(self, table: torch.Tensor, t: int):
        self.table = table              # [n_specs, rows, N_COLS] encoded
        self.t = t
        self.n_specs = table.shape[0]
        self.sidx = torch.arange(self.n_specs, device=table.device)[:, None]

    def apply(self, oc: ObsCarry, present: torch.Tensor, col) -> ObsCarry:
        """Apply one event per line: ``present`` [L] bool, ``col`` an int
        or a per-line [L] column id (single symbol or composite)."""
        if self.n_specs == 0:
            return oc
        if isinstance(col, torch.Tensor):
            col = torch.clamp(col.long(), 0, N_COLS - 1)
        entry = self.table[self.sidx, oc.nfa_mask, col]  # [n_specs, L]
        vsym = (entry >> 16) - 1          # -1 = clean transition
        viol = present & (vsym >= 0)
        hit = viol.any(1)
        new = hit & ~oc.viol_found
        vline = torch.argmax(viol.to(torch.int32), 1)[:, None]
        return oc._replace(
            nfa_mask=torch.where(present, entry & 0xFFFF, oc.nfa_mask),
            viol_found=oc.viol_found | hit,
            viol_step=oc.viol_step.masked_fill(new, self.t),
            viol_line=torch.where(new, vline[:, 0], oc.viol_line),
            viol_sym=torch.where(new, vsym.gather(1, vline)[:, 0],
                                 oc.viol_sym),
            viol_mask=torch.where(new, oc.nfa_mask.gather(1, vline)[:, 0],
                                  oc.viol_mask))

    @staticmethod
    def pair_col(pa: torch.Tensor, pb: torch.Tensor, pair_idx: int):
        """Column + presence for a same-step symbol pair: the composite
        column where both fire on a line, the single symbol elsewhere."""
        a, b = SYMBOL_PAIRS[pair_idx]
        col = torch.where(pa & pb, N_SYMBOLS + pair_idx,
                          torch.where(pa, a, b))
        return col, pa | pb


def fold_obs(cfg: ObserveConfig, tables: torch.Tensor, oc: ObsCarry,
             ev: StepEvents, t: int, line_filt: Optional[torch.Tensor],
             type_filt: Optional[torch.Tensor], *, newly: torch.Tensor,
             born_d: torch.Tensor, retired: torch.Tensor) -> ObsCarry:
    """Fold one step's wire events (on flat lines) into the carry.

    Sites run in the engine's delivery order (hresp arrivals, voluntary
    downgrades, request acceptance, grant issue, home-downgrade
    delivery), the per-line order ``check_trace`` sees in the exported
    ring, so online and offline verdicts agree.  ``newly``/``born_d``/
    ``retired`` are the driver's ``[R, L]`` per-transaction planes that
    feed phase attribution.  A step with no event, acceptance,
    retirement or injection leaves the carry as it was."""
    R, L = ev.hresp_arr.shape
    c = _consts(R, L, cfg.port, str(ev.hresp_arr.device))
    chk = _Checker(tables, t)
    keeps, words = [], []

    def stage(keep, msg, base, extra=None):
        """Record a capture site: ``keep`` its full-width lane mask,
        ``base`` the word bits its lanes' positions fix, ``msg`` the
        message type (a tensor or an int), ``extra`` its other bits."""
        if not cfg.capture:
            return
        if line_filt is not None:       # broadcasts over the last axis
            keep = keep & line_filt
        if type_filt is not None:
            keep = keep & (type_filt[msg] if isinstance(msg, int) else
                           type_filt[torch.clamp(msg.long(), 0, 15)])
        w = base | msg if isinstance(msg, int) else base | msg.long()
        keeps.append(keep.reshape(-1))
        words.append((w if extra is None else w | extra).reshape(-1))

    # ---- site 1: downgrade replies arrive at the home (hresp) -----------
    stage(ev.hresp_arr, ev.hresp_msg, c.base_rl[tp.CLASS_REMOTE_RESP],
          ev.hresp_dirty.long() * 0x300)        # has_payload and dirty
    col, pres = chk.pair_col(
        (ev.hresp_arr & (ev.hresp_msg == _DD)).any(0),
        (ev.hresp_arr & (ev.hresp_msg == int(MsgType.RESP_ACK))).any(0), 0)
    oc = chk.apply(oc, pres, col)
    if cfg.attribution:
        oc = oc._replace(last_reply=oc.last_reply.masked_fill(
            ev.hresp_arr.any(0), t))

    # ---- site 2: voluntary downgrades absorbed at the home --------------
    stage(ev.vol_arr, ev.vol_msg, c.base_rl[tp.CLASS_REMOTE_REQ],
          ev.vol_dirty.long() * 0x300)
    col, pres = chk.pair_col(
        (ev.vol_arr & (ev.vol_msg == int(MsgType.VOL_DOWNGRADE_S))).any(0),
        (ev.vol_arr & (ev.vol_msg == int(MsgType.VOL_DOWNGRADE_I))).any(0),
        1)
    oc = chk.apply(oc, pres, col)

    # ---- site 3: request acceptance (one winner per line) ---------------
    stage(ev.req_acc, ev.req_msg, c.base_l[tp.CLASS_REMOTE_REQ],
          ev.req_node.long() << 10)
    oc = chk.apply(oc, ev.req_acc, ev.req_msg)
    if cfg.inject is not None:
        step, line, imsg = (int(x) for x in cfg.inject)
        inj_now = (c.lines == line) & (t == step)
        stage(inj_now, imsg, c.base_l[tp.CLASS_REMOTE_REQ])
        oc = chk.apply(oc, inj_now, imsg)
    if cfg.attribution:
        oc = oc._replace(
            park_step=oc.park_step.masked_fill(ev.req_acc, t),
            park_hd=oc.park_hd & ~ev.req_acc)

    # ---- site 4: grant responses issued by the home ---------------------
    stage(ev.grant, ev.grant_msg, c.base_l[tp.CLASS_HOME_RESP],
          (ev.grant_pay.long() << 8) | ((ev.grant_msg == _DD).long() << 9)
          | (ev.grant_node.long() << 10))
    oc = chk.apply(oc, ev.grant, ev.grant_msg)

    # ---- site 5: home-initiated downgrades delivered to remotes ---------
    stage(ev.hd_arr, ev.hd_msg, c.base_rl[tp.CLASS_HOME_REQ])
    col, pres = chk.pair_col(
        (ev.hd_arr & (ev.hd_msg == int(MsgType.HOME_DOWNGRADE_S))).any(0),
        (ev.hd_arr & (ev.hd_msg == int(MsgType.HOME_DOWNGRADE_I))).any(0),
        2)
    oc = chk.apply(oc, pres, col)
    if cfg.attribution:
        oc = oc._replace(park_hd=oc.park_hd | ev.hd_arr.any(0))

    # ---- one compacted ring append for all sites ------------------------
    if keeps:
        oc = _ring_append(oc, torch.cat(keeps), torch.cat(words), t, c,
                          cfg.capacity)

    # ---- phase histograms: queue/service per txn, home/fanout per line --
    if cfg.attribution:
        hist = _hist_add(oc.phase_hist[0:2], torch.stack([newly, retired]),
                         torch.stack([t - born_d, t - oc.acc_step]), c)
        hist2 = _hist_add(
            oc.phase_hist[2:4], torch.stack([ev.grant,
                                             ev.grant & oc.park_hd]),
            torch.stack([t - oc.park_step, oc.last_reply - oc.park_step]),
            c)
        oc = oc._replace(phase_hist=torch.cat([hist, hist2]),
                         acc_step=oc.acc_step.masked_fill(newly, t))
    return oc


# ---------------------------------------------------------------------------
# Host-side readout.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OnlineViolation:
    """First counterexample one online spec latched during the run."""

    spec: str
    step: int
    line: int
    symbol: str
    states_before: FrozenSet[str]

    def __str__(self) -> str:
        return (f"[{self.spec}] step {self.step} line {self.line}: "
                f"'{self.symbol}' not allowed from "
                f"{set(self.states_before)}")


@dataclasses.dataclass
class ObsResult:
    """Host-side digest of an observed run."""

    config: ObserveConfig
    words: np.ndarray               # [n_kept] uint64, oldest first
    captured_total: int             # words seen (>= len(words) on wrap)
    dropped: int                    # words lost to the port cap
    violations: List[OnlineViolation]
    phase_hist: Optional[np.ndarray]   # [N_PHASES, N_LAT_BUCKETS]

    def trace_buffer(self) -> TraceBuffer:
        return TraceBuffer.from_words(
            self.words, capacity=max(self.config.capacity, 1))

    def phase_percentiles(self) -> Dict[str, Dict[str, float]]:
        from .counters import hist_percentiles
        if self.phase_hist is None:
            return {}
        return {ph: hist_percentiles(self.phase_hist[i])
                for i, ph in enumerate(PHASES)}

    def metrics(self) -> Dict[str, object]:
        return {
            "captured_words": int(len(self.words)),
            "captured_total": int(self.captured_total),
            "dropped_words": int(self.dropped),
            "specs": list(self.config.specs),
            "violations": [dataclasses.asdict(v) |
                           {"states_before": sorted(v.states_before)}
                           for v in self.violations],
            "phase_hist": (self.phase_hist.tolist()
                           if self.phase_hist is not None else None),
            "phase_percentiles": self.phase_percentiles(),
        }


def finalize_obs(cfg: ObserveConfig, oc: ObsCarry,
                 comp: Tuple[CompiledSpec, ...]) -> ObsResult:
    pos = int(oc.ring_pos)
    words = np.zeros((0,), np.uint64)
    if cfg.capture and pos:
        full = oc.ring[:cfg.capacity].cpu().numpy().view(np.uint64)
        if pos <= cfg.capacity:
            words = full[:pos].copy()
        else:                       # wrapped: rotate oldest-first
            start = pos % cfg.capacity
            words = np.concatenate([full[start:], full[:start]])
    found = oc.viol_found.cpu().numpy()
    vstep, vline, vsym, vmask = (x.cpu().numpy() for x in (
        oc.viol_step, oc.viol_line, oc.viol_sym, oc.viol_mask))
    violations = [
        OnlineViolation(spec=c.name, step=int(vstep[i]),
                        line=int(vline[i]),
                        symbol=symbol_id_name(int(vsym[i])),
                        states_before=c.mask_states(int(vmask[i])))
        for i, c in enumerate(comp) if found[i]]
    hist = oc.phase_hist.cpu().numpy() if cfg.attribution else None
    return ObsResult(config=cfg, words=words, captured_total=pos,
                     dropped=int(oc.ring_dropped), violations=violations,
                     phase_hist=hist)


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace-event timeline export.
# ---------------------------------------------------------------------------


def perfetto_events(tb: TraceBuffer, n_homes: int = 1) -> Dict[str, object]:
    """Chrome trace-event JSON from a captured EWF trace.

    One engine step maps to one microsecond of trace time.  ``home h``
    processes carry the per-home wire activity (requests accepted, grants
    issued, voluntary downgrades and fan-out replies absorbed) plus
    per-line transaction SPANS (request park -> grant); ``remote r``
    processes carry home-initiated downgrade deliveries.  Load the result
    into https://ui.perfetto.dev or chrome://tracing.
    """
    events: List[dict] = []
    open_req: Dict[int, Tuple[int, str]] = {}     # line -> (step, name)
    for m in tb.messages():
        msg, vc = int(m.msg_type), int(m.vc)
        node, line, step = int(m.node), int(m.line), int(m.txn)
        name = MsgType(msg).name
        klass = vc // 2
        if klass == tp.CLASS_HOME_REQ:
            pid, label = f"remote {node}", "deliver"
        else:
            pid = f"home {line % max(n_homes, 1)}"
            label = {tp.CLASS_REMOTE_REQ: "accept",
                     tp.CLASS_HOME_RESP: "grant",
                     tp.CLASS_REMOTE_RESP: "reply"}.get(klass, "wire")
        events.append({
            "name": f"{name} L{line}", "ph": "i", "ts": step, "s": "t",
            "pid": pid, "tid": f"{label}",
            "args": {"line": line, "node": node, "vc": vc,
                     "dirty": bool(m.dirty)},
        })
        if klass == tp.CLASS_REMOTE_REQ and msg in (
                int(MsgType.REQ_READ_SHARED), int(MsgType.REQ_READ_EXCL),
                int(MsgType.REQ_UPGRADE)):
            open_req[line] = (step, name)
        elif klass == tp.CLASS_HOME_RESP and line in open_req:
            t0, rname = open_req.pop(line)
            events.append({
                "name": f"{rname} L{line}", "ph": "X",
                "ts": t0, "dur": max(step - t0, 1),
                "pid": f"home {line % max(n_homes, 1)}",
                "tid": f"line {line}",
                "args": {"line": line, "grant": name,
                         "latency_steps": step - t0},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"time_unit": "1 us == 1 engine step"}}


def write_perfetto(tb: TraceBuffer, path: str, n_homes: int = 1) -> None:
    with open(path, "w") as f:
        json.dump(perfetto_events(tb, n_homes=n_homes), f)
