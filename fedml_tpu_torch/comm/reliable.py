"""Reliable wire delivery: at-least-once transport, exact-once handlers
(counterpart of ``fedml_tpu/comm/reliable.py``).

The edge transports are fire-and-forget, and the edge protocols advance by
counting messages, so one dropped message hangs a barrier and one
duplicate counts an upload twice. :class:`ReliableCommManager` wraps any
transport and gives the protocols at-least-once delivery with exact-once
handling, with no change to them:

- a send stamps a per-(sender, receiver) sequence number, a message id and
  the layer's incarnation, transmits synchronously (a transport's refusal
  still raises, so a fault-tolerant server's mark-dead path works) and
  keeps the message until it is acked; a retransmit thread sends it again
  with capped exponential backoff, a bounded number of times;
- a receive acks every stamped message, then drops it if its (sender,
  incarnation, seq) was seen, so a handler sees each message once however
  many copies arrive, and a restarted rank's new stream (a new incarnation,
  seq back at 0) is not taken for its predecessor's duplicates;
- a stop drains: the receive loop lives until the outstanding sends are
  acked, their retries run out or a drain timeout passes, so a FINISH lost
  on the wire is still sent again after the server has decided to stop.

Acks are fire-and-forget (a lost ack costs a retransmit that dedup eats).
Unstamped messages (local control events such as the straggler deadline, or
a peer without the layer) skip ack and dedup, which is also why a run with
no faults delivers the same content in the same order as the bare
transport. ``WIRE_BUSY`` (a receiver's push-back; the gateway sends it,
ROADMAP §1 item 11b's gateway) re-arms a pending send's retry clock without
spending a retry, or, terminal, evicts the sender.

Counters are a plain dict per layer (``stats``, JAX's key names; the JAX
package's registry-backed counter groups are ROADMAP §1 item 12), read by
``utils/metrics.wire_stats`` under ``wire/``. The JAX layer's tracer instant
on a retransmit and its flight-recorder dump on a peer's death are item
12's and are left out.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Dict, Optional

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.message import (KEY_ACK_MID, KEY_ACK_SEQ, MSG_ARG_KEY_WIRE_INC,
                                          MSG_ARG_KEY_WIRE_MID, MSG_ARG_KEY_WIRE_SEQ,
                                          MSG_TYPE_WIRE_ACK, MSG_TYPE_WIRE_BUSY, Message)

log = logging.getLogger(__name__)

__all__ = ["KEY_ACK_MID", "KEY_ACK_SEQ", "KEY_BUSY_MID", "KEY_BUSY_RETRY_S",
           "KEY_BUSY_TERMINAL", "KEY_BUSY_REASON", "MAX_BUSY_REARMS_PER_RETRY",
           "ReliableCommManager", "retry_schedule", "retry_budget_s", "build_wire_stack",
           "wire_wrap_factory"]

# a WIRE_BUSY's payload: the pushed-back message id, the seconds to hold
# off, and for an admission refusal or an eviction a terminal flag and a
# reason
KEY_BUSY_MID = "busy_mid"
KEY_BUSY_RETRY_S = "retry_after_s"
KEY_BUSY_TERMINAL = "terminal"
KEY_BUSY_REASON = "reason"

#: busy re-arms a pending message may take a retry before WIRE_BUSY stops
#: resetting its clock: a receiver busy for ever must end as a dead peer
#: (gave_up), not hold its sender in a live-lock
MAX_BUSY_REARMS_PER_RETRY = 4


class _Pending:
    __slots__ = ("msg", "receiver", "attempts", "next_due", "in_flight", "busy_rearms")

    def __init__(self, msg: Message, receiver: int, next_due: float):
        self.msg = msg
        self.receiver = receiver
        self.attempts = 0          # retransmits (the first send not counted)
        self.next_due = next_due
        self.in_flight = False     # a send of it is running
        self.busy_rearms = 0


def _backoff_of(base: float, cap: float, attempt: int) -> float:
    return min(float(base) * (2 ** attempt), float(cap))


class ReliableCommManager(BaseCommunicationManager, Observer):
    """ACK / retransmit and dedup over any transport (module note)."""

    #: ``utils/metrics.wire_stats`` reports ``stats`` under this prefix
    stats_prefix = "wire"

    def __init__(self, inner: BaseCommunicationManager, rank: Optional[int] = None,
                 retry_base_s: float = 0.05, retry_cap_s: float = 1.0, retry_max: int = 10,
                 # outlives a full retry exhaustion (~6.6 s at the defaults):
                 # the drain hosts the retries it waits for
                 drain_timeout_s: float = 8.0, dedup_window: int = 4096,
                 # a (sender, incarnation) window idle this long is dropped
                 # (None: ~8x the retry budget, past which no bounded
                 # retransmit can still arrive)
                 idle_gc_s: Optional[float] = None):
        super().__init__(codec=inner.codec)
        self.inner = inner
        self.rank = int(rank if rank is not None else getattr(inner, "rank", 0))
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        self.retry_max = int(retry_max)
        self.drain_timeout_s = float(drain_timeout_s)
        self.dedup_window = int(dedup_window)
        self._seq: Dict[int, int] = {}                 # receiver -> next seq
        self._outstanding: Dict[str, _Pending] = {}    # mid -> pending send
        self._seen: Dict[tuple, set] = {}              # (sender, incarnation) -> seqs
        self._seen_touch: Dict[tuple, float] = {}      # last activity of a pair
        budget = sum(_backoff_of(retry_base_s, retry_cap_s, i) for i in range(self.retry_max + 1))
        self.idle_gc_s = float(idle_gc_s) if idle_gc_s is not None else max(30.0, 8.0 * budget)
        self._next_gc = time.monotonic() + self.idle_gc_s
        self._inc = uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stopping = False
        self._closed = False
        # peers that exhausted a message's retries and have not acked since:
        # peer_dead counts each entry (a death, not each abandoned message)
        self._dead_peers: set = set()
        self.stats = dict.fromkeys(("sent", "retransmits", "retransmit_errors", "gave_up",
                                    "acked", "acks_sent", "delivered", "dup_dropped",
                                    "peer_dead", "busy_backoff", "evicted"), 0)
        #: ``(receiver_rank, msg) -> None``, called off the lock when a
        #: message to that peer exhausts its retries: the death oracle an
        #: asynchronous protocol ejects a crashed client by
        self.on_gave_up = None
        inner.add_observer(self)
        self._retx = threading.Thread(target=self._retransmit_loop, daemon=True,
                                      name=f"wire-retx-{self.rank}")
        self._retx.start()

    # -- send path -------------------------------------------------------
    def send_message(self, msg: Message) -> None:
        receiver = int(msg.get_receiver_id())
        with self._cv:
            if MSG_ARG_KEY_WIRE_SEQ not in msg:
                seq = self._seq.get(receiver, 0)
                self._seq[receiver] = seq + 1
                msg.add_params(MSG_ARG_KEY_WIRE_SEQ, seq)
                msg.add_params(MSG_ARG_KEY_WIRE_MID, uuid.uuid4().hex)
                msg.add_params(MSG_ARG_KEY_WIRE_INC, self._inc)
            mid = msg.get(MSG_ARG_KEY_WIRE_MID)
            pend = _Pending(msg, receiver, time.monotonic() + self._backoff(0))
            # in flight from the start: the retry clock does not run while
            # the first (blocking) transmit still serializes a large payload
            pend.in_flight = True
            self._outstanding[mid] = pend
            self.stats["sent"] += 1
        try:
            self.inner.send_message(msg)
        except Exception:
            # the transport refused the send (a dead peer): raise as the bare
            # transport would, and stop tracking; retransmits are for
            # silent loss
            with self._cv:
                self._outstanding.pop(mid, None)
                self._cv.notify()
            raise
        with self._cv:
            # the clock starts at the transmit's end (the ack may be in)
            if mid in self._outstanding:
                pend.in_flight = False
                pend.next_due = time.monotonic() + self._backoff(0)
            self._cv.notify()

    def _backoff(self, attempt: int) -> float:
        return _backoff_of(self.retry_base_s, self.retry_cap_s, attempt)

    def _retransmit_loop(self) -> None:
        while True:
            due, gave_up = [], []
            with self._cv:
                if self._closed:
                    return
                now = time.monotonic()
                wait = 0.25
                for mid in list(self._outstanding):
                    p = self._outstanding[mid]
                    if p.in_flight:
                        continue
                    if p.next_due > now:
                        wait = min(wait, p.next_due - now)
                        continue
                    p.attempts += 1
                    if p.attempts > self.retry_max:
                        self._outstanding.pop(mid)
                        self.stats["gave_up"] += 1
                        if p.receiver not in self._dead_peers:
                            self._dead_peers.add(p.receiver)
                            self.stats["peer_dead"] += 1
                        gave_up.append(p)
                        self._cv.notify_all()
                        log.warning("rank %d: message %r to %d unacked after %d retries; "
                                    "giving up", self.rank, p.msg.get_type(), p.receiver,
                                    self.retry_max)
                        continue
                    p.next_due = now + self._backoff(p.attempts)
                    p.in_flight = True
                    due.append(p)
                if now >= self._next_gc:
                    self._gc_idle_pairs(now)
                    self._next_gc = now + max(0.05, self.idle_gc_s / 4.0)
                if not due and not gave_up:
                    self._cv.wait(timeout=wait)
                    continue
            for p in gave_up:
                cb = self.on_gave_up
                if cb is not None:
                    try:
                        cb(p.receiver, p.msg)
                    except Exception:
                        log.exception("rank %d: on_gave_up hook failed", self.rank)
            # a thread a due message: a send blocked on a dead peer (gRPC's
            # wait_for_ready) must not starve the retransmits to live ones
            for p in due:
                threading.Thread(target=self._retransmit_one, args=(p,), daemon=True,
                                 name=f"wire-retx-{self.rank}-send").start()

    def _retransmit_one(self, p: _Pending) -> None:
        key = "retransmits"
        try:
            self.inner.send_message(p.msg)
        except Exception as e:
            key = "retransmit_errors"
            log.debug("rank %d: retransmit to %s failed (%s)", self.rank, p.receiver, e)
        finally:
            with self._cv:
                self.stats[key] += 1
                p.in_flight = False
                self._cv.notify_all()

    # -- receive path (an Observer of the inner transport) ---------------
    def receive_message(self, msg_type, msg: Message) -> None:
        if msg_type == MSG_TYPE_WIRE_ACK:
            with self._cv:
                p = self._outstanding.pop(msg.get(KEY_ACK_MID), None)
                if p is not None:
                    self.stats["acked"] += 1
                    # proof of life: a peer that died and came back counts as
                    # a new death next time
                    self._dead_peers.discard(p.receiver)
                    self._cv.notify_all()
            return
        if msg_type == MSG_TYPE_WIRE_BUSY:
            self._handle_busy(msg)
            return
        seq = msg.get(MSG_ARG_KEY_WIRE_SEQ)
        if seq is None:
            self._notify(msg)      # unstamped: delivered as it is
            return
        sender = int(msg.get_sender_id())
        with self._lock:
            stopping = self._stopping
        # ack receipt into the dedup layer, before dispatch; a draining layer
        # acks no more (its peer is usually stopping too, and a blocking
        # transport would pin this thread on a dead endpoint)
        if not stopping:
            ack = Message(MSG_TYPE_WIRE_ACK, self.rank, sender)
            ack.add_params(KEY_ACK_MID, msg.get(MSG_ARG_KEY_WIRE_MID))
            ack.add_params(KEY_ACK_SEQ, int(seq))
            try:
                self.inner.send_message(ack)
                # the receive thread is the one writer of the receive-side
                # counters
                self.stats["acks_sent"] += 1
            except Exception as e:   # a lost ack: the retransmit covers it
                log.debug("rank %d: ack to %d failed (%s)", self.rank, sender, e)
        with self._lock:
            dup = self._is_dup_and_mark((sender, msg.get(MSG_ARG_KEY_WIRE_INC)), int(seq))
        if dup:
            self.stats["dup_dropped"] += 1
            return
        self.stats["delivered"] += 1
        self._notify(msg)

    def _handle_busy(self, msg: Message) -> None:
        """A receiver's push-back. Non-terminal: re-arm the pending message's
        retry clock at the suggested delay without spending a retry (busy is
        not dead), at most MAX_BUSY_REARMS_PER_RETRY x retry_max times.
        Terminal (an admission refusal, an eviction): abandon every
        outstanding send and stop the layer."""
        if msg.get(KEY_BUSY_TERMINAL):
            with self._cv:
                self._outstanding.clear()
                self.stats["evicted"] += 1
                self._cv.notify_all()
            log.warning("rank %d: evicted by receiver (%s)", self.rank,
                        msg.get(KEY_BUSY_REASON) or "no reason given")
            self.stop_receive_message()
            return
        retry_after = float(msg.get(KEY_BUSY_RETRY_S) or self.retry_base_s * 4.0)
        with self._cv:
            p = self._outstanding.get(msg.get(KEY_BUSY_MID))
            if p is not None and p.busy_rearms < self.retry_max * MAX_BUSY_REARMS_PER_RETRY:
                p.busy_rearms += 1
                p.attempts = 0
                p.next_due = time.monotonic() + retry_after
                self.stats["busy_backoff"] += 1
                self._cv.notify_all()

    def _is_dup_and_mark(self, sender: tuple, seq: int) -> bool:
        self._seen_touch[sender] = time.monotonic()
        seen = self._seen.setdefault(sender, set())
        if seq in seen:
            return True
        seen.add(seq)
        if len(seen) > self.dedup_window:
            # nothing this far behind can still be retransmitted
            cutoff = max(seen) - self.dedup_window
            self._seen[sender] = {s for s in seen if s >= cutoff}
        return False

    def _gc_idle_pairs(self, now: float) -> None:
        """Drop the dedup windows of (sender, incarnation) pairs idle past
        the horizon (under the lock): retries are bounded, so no duplicate
        of a message seen that long ago can still arrive."""
        cutoff = now - self.idle_gc_s
        for pair in [p for p, t in self._seen_touch.items() if t < cutoff]:
            self._seen.pop(pair, None)
            self._seen_touch.pop(pair, None)

    # -- lifecycle -------------------------------------------------------
    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        # the stop usually comes from a handler on the receive thread, so
        # the drain waits on a helper thread
        with self._cv:
            if self._stopping:
                return
            self._stopping = True
        threading.Thread(target=self._drain_and_stop, daemon=True,
                         name=f"wire-drain-{self.rank}").start()

    def _drain_and_stop(self) -> None:
        deadline = time.monotonic() + self.drain_timeout_s
        with self._cv:
            while self._outstanding and time.monotonic() < deadline:
                self._cv.wait(timeout=0.05)
            self._closed = True
            self._cv.notify_all()
        self.inner.stop_receive_message()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the retransmit thread to end (after a stop's drain);
        whether it has."""
        self._retx.join(timeout)
        return not self._retx.is_alive()

    def inject_local(self, msg: Message) -> None:
        self.inner.inject_local(msg)

    def supports_local_injection(self) -> bool:
        return self.inner.supports_local_injection()


def retry_schedule(config) -> tuple[float, float, int]:
    """(base_s, cap_s, retry_max) of ``config``; the cap is 20x the base
    (0.05 / 1.0 by default), so one knob retunes the schedule."""
    base = float(getattr(config, "wire_retry_base_s", 0.05) or 0.05)
    return base, 20.0 * base, int(getattr(config, "wire_retry_max", 10) or 10)


def retry_budget_s(config) -> float:
    """The backoff a message spends before it gives up under ``config``'s
    schedule: the wire's latency to declare a peer dead. Probe and
    keepalive cadences derive from it."""
    base, cap, retry_max = retry_schedule(config)
    return float(sum(min(base * (2 ** i), cap) for i in range(retry_max + 1)))


def build_wire_stack(comm: BaseCommunicationManager, config, rank: int
                     ) -> BaseCommunicationManager:
    """Wrap a bare transport as ``config`` asks: chaos innermost (it is the
    wire), the reliable layer over it (it recovers what chaos breaks)."""
    from fedml_tpu_torch.comm.chaos import ChaosCommManager, chaos_enabled

    if chaos_enabled(config):
        crash_after = (config.chaos_crash_after
                       if getattr(config, "chaos_crash_rank", None) == rank else None)
        comm = ChaosCommManager(
            comm, drop=getattr(config, "chaos_drop", 0.0), dup=getattr(config, "chaos_dup", 0.0),
            delay_ms=getattr(config, "chaos_delay_ms", 0.0),
            reorder=getattr(config, "chaos_reorder", 0.0), seed=getattr(config, "chaos_seed", 0),
            rank=rank, crash_after_sends=crash_after,
            restart_after_s=(getattr(config, "chaos_crash_restart_s", None)
                             if crash_after is not None else None))
    if getattr(config, "wire_reliable", False):
        base, cap, retry_max = retry_schedule(config)
        comm = ReliableCommManager(comm, rank=rank, retry_base_s=base, retry_cap_s=cap,
                                   retry_max=retry_max,
                                   # the drain hosts a retry exhaustion
                                   drain_timeout_s=retry_budget_s(config) + 0.5)
    return comm


def wire_wrap_factory(config):
    """``(rank, comm) -> comm`` for ``run_ranks(wrap=)``, or None when
    ``config`` asks for neither the reliable layer nor chaos (the bare
    transports then run untouched)."""
    from fedml_tpu_torch.comm.chaos import chaos_enabled

    if not (getattr(config, "wire_reliable", False) or chaos_enabled(config)):
        return None
    return lambda rank, comm: build_wire_stack(comm, config, rank)
