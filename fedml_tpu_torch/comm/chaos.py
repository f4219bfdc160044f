"""Seeded chaos injection for the edge transports (counterpart of
``fedml_tpu/comm/chaos.py``).

:class:`ChaosCommManager` wraps a bare transport and misbehaves like a lossy
WAN on the send side: it drops, duplicates, delays and reorders messages,
and can crash-stop its rank after a number of sends (a killed process).
With ``restart_after_s`` the crash is a crash-restart: the rank goes silent
both ways (sends swallowed, deliveries dropped, the receive loop kept
alive) and revives after the delay; ``on_restart`` lets the protocol
re-announce itself (the FedBuff client sends JOIN from it).

Every fate is drawn from ``np.random.default_rng([seed, blake2s(repr(ident)),
attempt])``: a pure function of the seed, the message's identity and its
delivery attempt, never of a shared stream, so the retransmit thread racing
the protocol thread cannot change which copies the wire eats; the draws
are the JAX package's, so both drop the same copies. The crash counts
logical protocol messages (first attempts of non-ack messages), not wire
sends, whose number depends on thread timing: the set of messages a crashed
rank managed to send is a function of the seeds, which is what lets
FedBuff's deterministic mode replay bit for bit under crash chaos.

Chaos sits under the reliable layer (``comm/reliable.py``), so acks cross
the same lossy wire. ``FedConfig`` refuses drop, dup and reorder without the
reliable layer on top: the message-counting barriers would hang or count a
message twice.

Counters are a plain dict per layer (``stats``, JAX's key names; the JAX
package's registry-backed counter groups are ROADMAP §1 item 12), read by
``utils/metrics.wire_stats`` under ``chaos/``. The JAX layer's tracer
instant on a drop is item 12's and is left out.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import Optional

import numpy as np

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer, find_layer
from fedml_tpu_torch.comm.message import (KEY_ACK_SEQ, MSG_ARG_KEY_WIRE_SEQ, MSG_TYPE_WIRE_ACK,
                                          Message)

log = logging.getLogger(__name__)

#: the rate fields, any of which turns the layer on (chaos_enabled)
CHAOS_RATE_FIELDS = ("chaos_drop", "chaos_dup", "chaos_delay_ms", "chaos_reorder")


def chaos_enabled(config) -> bool:
    """Whether ``config`` asks for chaos: a nonzero rate or a crash rank."""
    if any(getattr(config, f, 0.0) for f in CHAOS_RATE_FIELDS):
        return True
    return getattr(config, "chaos_crash_rank", None) is not None


def fate_ident(msg: Message) -> tuple:
    """The logical identity of a transmission: retransmits of one stamped
    message share it and are told apart by the attempt index."""
    if msg.get_type() == MSG_TYPE_WIRE_ACK:
        return ("ack", msg.get_sender_id(), msg.get_receiver_id(), msg.get(KEY_ACK_SEQ))
    seq = msg.get(MSG_ARG_KEY_WIRE_SEQ)
    return ("msg", msg.get_sender_id(), msg.get_receiver_id(),
            seq if seq is not None else str(msg.get_type()))


def fate_draws(seed: int, ident: tuple, attempt: int) -> np.ndarray:
    """The four uniform draws of one transmission's fate (drop, dup,
    reorder, delay), all four always drawn so that changing one rate deals
    the others the same."""
    digest = hashlib.blake2s(repr(ident).encode(), digest_size=8).digest()
    return np.random.default_rng([int(seed), int.from_bytes(digest, "big"),
                                  int(attempt)]).random(4)


class ChaosCommManager(BaseCommunicationManager, Observer):
    #: ``utils/metrics.wire_stats`` reports ``stats`` under this prefix
    stats_prefix = "chaos"

    def __init__(self, inner: BaseCommunicationManager, drop: float = 0.0, dup: float = 0.0,
                 delay_ms: float = 0.0, reorder: float = 0.0, seed: int = 0, rank: int = 0,
                 crash_after_sends: Optional[int] = None,
                 restart_after_s: Optional[float] = None):
        super().__init__(codec=inner.codec)
        self.inner = inner
        self.drop = float(drop)
        self.dup = float(dup)
        self.delay_ms = float(delay_ms)
        self.reorder = float(reorder)
        self.seed = int(seed)
        self.rank = int(rank)
        self.crash_after_sends = crash_after_sends
        self.restart_after_s = None if restart_after_s is None else float(restart_after_s)
        #: called (off-thread) at a crash-restart's revival
        self.on_restart = None
        self._sends = 0                # logical protocol messages sent
        self._occurrence: dict = {}    # fate ident -> attempts seen
        self._held = None              # the reorder hold: (msg, delay_s)
        self._crashed = False
        self._crash_fired = False      # the crash fires once
        self._lock = threading.Lock()
        self.stats = dict.fromkeys(("sent", "dropped", "duplicated", "delayed", "reordered",
                                    "crashed_dropped", "crash_stops", "crash_restarts"), 0)
        inner.add_observer(self)

    # -- send path -------------------------------------------------------
    def send_message(self, msg: Message) -> None:
        ident = fate_ident(msg)
        with self._lock:
            if self._crashed:
                self.stats["crashed_dropped"] += 1
                return
            attempt = self._occurrence.get(ident, 0)
            self._occurrence[ident] = attempt + 1
            if ident[0] != "ack" and (attempt == 0 or msg.get(MSG_ARG_KEY_WIRE_SEQ) is None):
                self._sends += 1
            crash_now = (self.crash_after_sends is not None and not self._crash_fired
                         and self._sends >= self.crash_after_sends)
            if crash_now:
                # marked under the lock the instant it is decided, so a
                # concurrent retransmit is swallowed in every interleaving;
                # this (the threshold) send still goes out
                self._crashed = True
                self._crash_fired = True
                self._held = None
                self.stats["crash_stops"] += 1
        r_drop, r_dup, r_reorder, u_delay = fate_draws(self.seed, ident, attempt)
        try:
            if r_drop < self.drop:
                with self._lock:
                    self.stats["dropped"] += 1
                return
            copies = 2 if r_dup < self.dup else 1
            if copies == 2:
                with self._lock:
                    self.stats["duplicated"] += 1
            delay_s = (u_delay * self.delay_ms / 1000.0) if self.delay_ms else 0.0
            for _ in range(copies):
                self._dispatch(msg, r_reorder < self.reorder, delay_s)
        finally:
            if crash_now:
                self._crash()

    def _dispatch(self, msg: Message, reorder_hit: bool, delay_s: float) -> None:
        to_send = []
        with self._lock:
            if reorder_hit and self._held is None:
                self._held = (msg, delay_s)
                self.stats["reordered"] += 1
            else:
                to_send.append((msg, delay_s))
                if self._held is not None:
                    to_send.append(self._held)
                    self._held = None
        for m, d in to_send:
            self._send_later(m, d)

    def _send_later(self, msg: Message, delay_s: float) -> None:
        if delay_s <= 0.0:
            with self._lock:
                self.stats["sent"] += 1
            self.inner.send_message(msg)
            return

        def fire():
            try:
                self.inner.send_message(msg)
            except Exception as e:   # a delayed send to a gone peer: wire loss
                log.debug("chaos rank %d: delayed send failed (%s)", self.rank, e)

        with self._lock:
            self.stats["delayed"] += 1
            self.stats["sent"] += 1
        t = threading.Timer(delay_s, fire)
        t.daemon = True
        t.start()

    def _crash(self) -> None:
        """The out-of-lock half of the crash: a crash-stop ends the receive
        loop; a crash-restart keeps it (deliveries are dropped while down)
        and arms the revival."""
        restart = self.restart_after_s
        log.warning("chaos: rank %d crash-stopped after %d protocol sends%s", self.rank,
                    self._sends, "" if restart is None else f" (restart in {restart:g}s)")
        if restart is None:
            self.inner.stop_receive_message()
            return
        t = threading.Timer(restart, self._restart)
        t.daemon = True
        t.start()

    def _restart(self) -> None:
        """The revival: traffic flows again both ways; what the wire carried
        during the outage is gone (the peers' retransmits recover what their
        retry budgets still cover)."""
        with self._lock:
            if not self._crashed:
                return
            self._crashed = False
            self.stats["crash_restarts"] += 1
            cb = self.on_restart
        log.warning("chaos: rank %d revived (crash_restart)", self.rank)
        if cb is not None:
            try:
                cb()
            except Exception:
                log.exception("chaos: rank %d on_restart hook failed", self.rank)

    # -- receive path ----------------------------------------------------
    def receive_message(self, msg_type, msg: Message) -> None:
        # read under the lock (the revival flips it), dispatch outside it:
        # handlers send
        with self._lock:
            crashed = self._crashed
        if not crashed:
            self._notify(msg)

    # -- lifecycle -------------------------------------------------------
    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        with self._lock:
            held, self._held = self._held, None
            crashed = self._crashed
        if held is not None and not crashed:
            # a reorder hold with no send after it is flushed, not dropped
            try:
                self.inner.send_message(held[0])
            except Exception as e:
                log.debug("chaos rank %d: flushing the held message failed (%s)", self.rank, e)
        self.inner.stop_receive_message()

    def inject_local(self, msg: Message) -> None:
        self.inner.inject_local(msg)

    def supports_local_injection(self) -> bool:
        return self.inner.supports_local_injection()


def find_chaos(comm) -> Optional[ChaosCommManager]:
    """The chaos layer of a wire stack, or None (a protocol hooks its
    ``on_restart``)."""
    return find_layer(comm, ChaosCommManager)
