"""Byte-accounting feature transport between hardware tiers.

The tiered runtime ships real serialized payloads between the glasses
and the edge box: raw modality data up, encoded features + head outputs
(and the piggybacked feature cache, per the paper's fault-tolerance
design) back down. A :class:`TransportChannel` models one direction of
that link on the simulated clock:

  * **payload sizing** — message sizes come from the actual device
    arrays being shipped (``payload_nbytes`` walks the pytree and sums
    ``size * itemsize``) plus a small fixed framing overhead;
  * **per-link latency** — every message pays a constant propagation /
    stack-traversal latency on top of its serialization time
    ``nbytes / bandwidth(t)``, with the bandwidth read from the same
    :class:`~repro_torch.core.offload.BandwidthTrace` that drives the offload
    decisions (decisions see the *heartbeat-quantized* measurement; the
    wire sees the true instantaneous value — the gap between the two is
    exactly the staleness a real heartbeat monitor suffers);
  * **in-order delivery** — a TCP-like stream: a message never overtakes
    an earlier one, so a delivery time is ``max(arrival, previous
    delivery)`` (head-of-line blocking under a bandwidth dip is modeled,
    not wished away). Taking the max, rather than adding the queueing
    delay back onto the arrival, keeps delivery times exactly
    non-decreasing: ``arrival + (last - arrival)`` can land one ulp below
    ``last``;
  * **cancellable flights** — every send is a *flight* with a unique id
    (fabric-wide when the channel belongs to a :class:`TierFabric`). A
    flight cancelled before its delivery instant NEVER delivers: the
    receiver never sees the bytes, and if the flight was the in-order
    frontier the wire frees at the cancel instant instead of the
    phantom full-delivery time. Speculative dual placement leans on
    this: the losing racer's in-flight transfer is cancelled at the
    winner's commit, so a stale result cannot arrive later and clobber
    a newer cache version (cancel-on-commit).

Lifetime byte/message counters make the transport cost auditable
(``stats()`` breaks them out per link).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from ..core.offload import BandwidthTrace
# THE byte-sizing rule lives in core; re-exported here because it is
# also the transport's charging rule.
from ..core.splitter import payload_nbytes  # noqa: F401
from ..obs import Metrics, Tracer


@dataclass
class Delivery:
    """Receipt for one message pushed through a channel."""
    t_send: float               # when the sender handed the bytes over
    t_deliver: float            # when the receiver has the full message
    nbytes: int
    transfer_s: float           # serialization time (nbytes / bandwidth)
    queued_s: float             # extra wait behind earlier in-flight messages
    flight: int = -1            # per-flight id (unique within its fabric)
    cancelled: bool = False     # cancel-on-commit: never delivers

    @property
    def delivered_at(self) -> Optional[float]:
        """Delivery instant, or None — a cancelled flight never
        delivers."""
        return None if self.cancelled else self.t_deliver


@dataclass
class TransportChannel:
    """One direction of a glass<->edge link on the simulated clock."""
    trace: BandwidthTrace
    latency_s: float = 0.005            # per-message propagation latency
    overhead_bytes: int = 64            # framing / header per message
    name: str = "link"
    # lifetime byte/message accounting lives on the (possibly shared)
    # metrics registry under "transport.<name>.*"; the historical
    # attributes survive as read-through properties below
    metrics: Optional[Metrics] = None
    tracer: Optional[Tracer] = None
    _last_deliver: float = field(default=0.0, repr=False)
    deliveries: List[Delivery] = field(default_factory=list, repr=False)
    max_history: Optional[int] = 256
    # flight-id allocator; a TierFabric injects ONE shared counter into
    # every channel it creates so ids are unique fabric-wide
    fids: Iterator[int] = field(default_factory=itertools.count,
                                repr=False)
    _flights: Dict[int, Delivery] = field(default_factory=dict,
                                          repr=False)

    def __post_init__(self):
        if self.metrics is None:
            self.metrics = Metrics()
        if self.tracer is None:
            self.tracer = Tracer.disabled

    # ---- legacy counter attributes (read-through to the registry)
    def _key(self, leaf: str) -> str:
        return f"transport.{self.name}.{leaf}"

    @property
    def bytes_sent(self) -> int:
        return int(self.metrics.get(self._key("bytes")))

    @property
    def msgs_sent(self) -> int:
        return int(self.metrics.get(self._key("msgs")))

    @property
    def busy_s(self) -> float:
        """Total serialization seconds."""
        return float(self.metrics.get(self._key("busy_s")))

    @property
    def cancelled_msgs(self) -> int:
        return int(self.metrics.get(self._key("cancelled_msgs")))

    @property
    def cancelled_bytes(self) -> int:
        return int(self.metrics.get(self._key("cancelled_bytes")))

    def eta(self, nbytes: int, t: float) -> float:
        """Delivery time a ``send(nbytes, t)`` WOULD produce, without
        mutating the channel — lets the fault path ask whether a sender
        would still be alive when its transmission completes."""
        transfer = (int(nbytes) + self.overhead_bytes) / self.trace.at(t)
        return max(t + self.latency_s + transfer, self._last_deliver)

    def send(self, nbytes: int, t: float) -> Delivery:
        """Ship ``nbytes`` at simulated time ``t``; returns the receipt.

        Transfer time uses the trace's true bandwidth at the send
        instant (piecewise-constant over the transfer — the traces the
        benchmarks sweep change on a ~1 s grid, coarser than any single
        message here). Delivery is in-order: never earlier than the
        previous message's delivery.
        """
        nbytes = int(nbytes) + self.overhead_bytes
        transfer = nbytes / self.trace.at(t)
        arrival = t + self.latency_s + transfer
        t_deliver = max(arrival, self._last_deliver)
        d = Delivery(t_send=t, t_deliver=t_deliver, nbytes=nbytes,
                     transfer_s=transfer, queued_s=t_deliver - arrival,
                     flight=next(self.fids))
        self._last_deliver = d.t_deliver
        self.metrics.inc(self._key("bytes"), nbytes)
        self.metrics.inc(self._key("msgs"))
        self.metrics.inc(self._key("busy_s"), transfer)
        if self.tracer:
            self.tracer.span(
                "transport.flight", "transport", d.t_send, d.t_deliver,
                track=f"link:{self.name}", flight=d.flight,
                channel=self.name, nbytes=d.nbytes, t_send=d.t_send,
                t_deliver=d.t_deliver, queued_s=d.queued_s)
        self.deliveries.append(d)
        self._flights[d.flight] = d
        if self.max_history is not None:
            del self.deliveries[:-self.max_history]
            if len(self._flights) > 4 * self.max_history:
                # Only flights already settled by the current clock —
                # delivered (t_deliver <= t) or cancelled — may be
                # dropped from the cancel index. A long-queued flight
                # whose t_deliver is still in the future must stay
                # cancellable no matter how many sends pass it.
                keep = {x.flight for x in self.deliveries}
                self._flights = {f: x for f, x in self._flights.items()
                                 if f in keep
                                 or (not x.cancelled and x.t_deliver > t)}
        return d

    def cancel(self, flight: int, t: Optional[float] = None) -> bool:
        """Abort an in-flight delivery (cancel-on-commit). Returns True
        iff the flight was live and got cancelled; a flight already
        delivered by ``t`` is past the commit point and cannot be
        recalled (False). A cancelled flight never delivers. If the
        flight was the in-order frontier, the wire frees at the cancel
        instant instead of the phantom full-delivery time."""
        d = self._flights.get(flight)
        if d is None or d.cancelled:
            return False
        if t is not None and t >= d.t_deliver:
            return False                # already delivered — too late
        d.cancelled = True
        self.metrics.inc(self._key("cancelled_msgs"))
        self.metrics.inc(self._key("cancelled_bytes"), d.nbytes)
        if self.tracer:
            self.tracer.instant(
                "transport.cancel", "transport",
                t if t is not None else d.t_send,
                track=f"link:{self.name}", flight=d.flight,
                channel=self.name, nbytes=d.nbytes,
                t=t if t is not None else d.t_send)
        if self._last_deliver == d.t_deliver:
            prev = max((x.t_deliver for x in self.deliveries
                        if not x.cancelled), default=0.0)
            self._last_deliver = max(prev, t if t is not None
                                     else d.t_send)
        return True

    def completed(self) -> List[Delivery]:
        """Deliveries that actually reached the receiver (cancelled
        flights never deliver)."""
        return [d for d in self.deliveries if not d.cancelled]

    def stats(self) -> dict:
        return {"name": self.name, "msgs": self.msgs_sent,
                "bytes": self.bytes_sent, "busy_s": self.busy_s,
                "cancelled_msgs": self.cancelled_msgs,
                "cancelled_bytes": self.cancelled_bytes}


# ======================================================================
# N-tier link fabric
# ======================================================================

@dataclass
class MinTrace:
    """Bandwidth of a remote<->remote path: each remote tier owns one
    radio link to the incident-local network, so a transfer between two
    remotes traverses both links and the slower one bottlenecks.
    Duck-types the ``at(t)`` surface :class:`TransportChannel` needs."""
    a: object
    b: object

    def at(self, t: float) -> float:
        return min(self.a.at(t), self.b.at(t))


class TierFabric:
    """Directional transport channels between any pair of tiers.

    ``traces`` maps each remote host name to the :class:`BandwidthTrace`
    of ITS radio link; the local tier (the glasses) terminates every
    link it participates in, so a local<->remote channel runs at the
    remote's trace and a remote<->remote channel at the min of the two
    (:class:`MinTrace`). Channels are created on demand and cached, so
    per-link in-order delivery state and byte accounting live exactly
    once per (src, dst) direction.
    """

    def __init__(self, local: str, traces: dict, *,
                 latency_s: float = 0.005, overhead_bytes: int = 64,
                 metrics: Optional[Metrics] = None,
                 tracer: Optional[Tracer] = None):
        self.local = local
        self.traces = dict(traces)
        self.latency_s = latency_s
        self.overhead_bytes = overhead_bytes
        self.metrics = metrics if metrics is not None else Metrics()
        self.tracer = tracer if tracer is not None else Tracer.disabled
        self._channels = {}
        # ONE flight-id space across every channel: a flight id names
        # its transfer unambiguously fabric-wide (cancel-on-commit
        # passes ids around without caring which link carries them)
        self._fids = itertools.count()

    def trace(self, src: str, dst: str):
        remotes = [t for t in (src, dst) if t != self.local]
        if not remotes:
            raise ValueError("no wire between a tier and itself")
        if len(remotes) == 1:
            return self.traces[remotes[0]]
        return MinTrace(self.traces[remotes[0]], self.traces[remotes[1]])

    def channel(self, src: str, dst: str) -> TransportChannel:
        key = (src, dst)
        ch = self._channels.get(key)
        if ch is None:
            ch = self._channels[key] = TransportChannel(
                self.trace(src, dst), latency_s=self.latency_s,
                overhead_bytes=self.overhead_bytes, name=f"{src}->{dst}",
                fids=self._fids, metrics=self.metrics,
                tracer=self.tracer)
        return ch

    def cancel(self, flight: int, t: Optional[float] = None) -> bool:
        """Cancel a flight by its fabric-wide id, whichever link carries
        it."""
        return any(ch.cancel(flight, t) for ch in self._channels.values())

    def cancelled_msgs(self) -> int:
        return sum(ch.cancelled_msgs for ch in self._channels.values())

    def stats(self) -> dict:
        return {f"{s}->{d}": ch.stats()
                for (s, d), ch in sorted(self._channels.items())}
