"""Scheduling cost model: what preemption/migration/resize actually cost.

Singularity's claim (§1, Table 5) is that its mechanisms are *cheap but
not free* — tens of seconds of downtime each — and that the scheduler
stays efficient despite paying them.  A simulator that never charges
those costs silently overstates every elastic-vs-static comparison, so
this module makes them a first-class input to the scheduler layer.

The per-job downtime decomposition mirrors ``core/migration.py``'s
measured end-to-end flow (Table 5):

  barrier   — in-graph quiesce; bounded at two mini-batches (§4.3)
  dump      — device+host state to local host memory
  transfer  — deduped checkpoint through the blob store (upload at the
              source, download at the destination); for a cross-region
              move the blob path is the slower inter-region link, so the
              transfer is weighted by the ``RegionTopology`` entry for
              the (source, destination) pair
  restore   — fresh rendezvous + state load + step recompile

``CheckpointStore`` dedups DP replicas, so checkpoint bytes are a
function of model-state size, not of the allocation (Table 4) — which is
why per-job bytes live on the job, not the cost model.  Both the
simulator and any analysis tooling consume the same model; a uniform
scalar configuration (``CostModel.uniform``) reproduces flat per-event
charges for controlled experiments, and ``CostModel.from_reports``
calibrates the derived model from measured ``MigrationReport`` runs so
the scheduler charges what the mechanisms actually cost on this host.

All per-event methods accept either a scalar ``checkpoint_bytes`` or a
numpy array (they are pure broadcastable arithmetic): the vectorized
``ElasticPolicy`` ranks whole job arrays through the same code path the
scalar oracle uses per job.

A copy of ``repro.scheduler.costs``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.utils import constants


@dataclasses.dataclass(frozen=True)
class RegionLink:
    """One source<->destination blob path between a pair of regions."""

    bandwidth: float
    latency_seconds: float = 0.0


class RegionTopology:
    """Source->destination transfer tiers between regions.

    Intra-region blob traffic runs at the full blob-store bandwidth with
    no extra latency.  Cross-region traffic pays the inter-region link:
    lower bandwidth (geo-replication shares the WAN) plus a flat
    latency charge (control-plane + first-byte).  Pairs without an
    explicit ``links`` entry fall back to the uniform cross-region tier,
    so a two-line topology is enough for controlled experiments while
    ``tiered`` builds a realistic near/far mesh.
    """

    def __init__(
        self,
        intra_bandwidth: float = constants.BLOB_STORE_BANDWIDTH,
        cross_bandwidth: Optional[float] = None,
        cross_latency_seconds: float = 2.0,
        links: Optional[Dict[Tuple[str, str], RegionLink]] = None,
    ):
        self.intra_bandwidth = float(intra_bandwidth)
        self.cross_bandwidth = (
            float(cross_bandwidth)
            if cross_bandwidth is not None
            else self.intra_bandwidth / 6.0
        )
        self.cross_latency_seconds = float(cross_latency_seconds)
        self.links: Dict[Tuple[str, str], RegionLink] = dict(links or {})

    def link(self, src: Optional[str], dst: Optional[str]) -> RegionLink:
        if src is None or dst is None or src == dst:
            return RegionLink(self.intra_bandwidth, 0.0)
        if (src, dst) in self.links:
            return self.links[(src, dst)]
        if (dst, src) in self.links:
            return self.links[(dst, src)]
        return RegionLink(self.cross_bandwidth, self.cross_latency_seconds)

    def bandwidth(self, src: Optional[str], dst: Optional[str]) -> float:
        return self.link(src, dst).bandwidth

    def latency_seconds(self, src: Optional[str], dst: Optional[str]) -> float:
        return self.link(src, dst).latency_seconds

    def transfer_factor(self, src: Optional[str], dst: Optional[str]) -> float:
        """How much slower the src->dst blob path is than intra-region
        (1.0 for an intra-region or unspecified pair)."""
        return self.intra_bandwidth / max(self.bandwidth(src, dst), 1e-9)

    @classmethod
    def tiered(
        cls,
        region_ids: Iterable[str],
        intra_bandwidth: float = constants.BLOB_STORE_BANDWIDTH,
        near_factor: float = 4.0,
        far_factor: float = 8.0,
        near_latency_seconds: float = 1.0,
        far_latency_seconds: float = 5.0,
    ) -> "RegionTopology":
        """Realistic two-tier mesh over an ordered region ring.

        Adjacent regions (ring distance 1: paired DCs on the same
        backbone) get the fast "near" tier; everything farther is the
        slow "far" tier — the intra/near/far split Singularity's global
        scheduler prices when it moves work across AzureML regions.
        """
        ids = list(region_ids)
        n = len(ids)
        links: Dict[Tuple[str, str], RegionLink] = {}
        for i in range(n):
            for k in range(i + 1, n):
                ring = min(k - i, n - (k - i))
                if ring <= 1:
                    links[(ids[i], ids[k])] = RegionLink(
                        intra_bandwidth / near_factor, near_latency_seconds
                    )
                else:
                    links[(ids[i], ids[k])] = RegionLink(
                        intra_bandwidth / far_factor, far_latency_seconds
                    )
        return cls(
            intra_bandwidth=intra_bandwidth,
            cross_bandwidth=intra_bandwidth / far_factor,
            cross_latency_seconds=far_latency_seconds,
            links=links,
        )


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Derives per-job preempt/restore/migrate/resize downtime (seconds).

    Downtime is charged to the *job*: wall time during which its
    allocation makes no progress (dead GPU time for held allocations,
    delayed resume for preempted ones).
    """

    blob_bandwidth: float = constants.BLOB_STORE_BANDWIDTH
    host_device_bandwidth: float = constants.HOST_DEVICE_BANDWIDTH
    barrier_minibatches: int = 2          # §4.3: quiesce within two steps
    minibatch_seconds: float = 0.5
    rendezvous_seconds: float = 5.0       # destination compile + rendezvous
    scale: float = 1.0                    # global knob (0 = free mechanisms)
    topology: Optional[RegionTopology] = None   # region-pair transfer tiers

    # ---------------------------------------------------------- components
    def barrier_seconds(self) -> float:
        return self.barrier_minibatches * self.minibatch_seconds

    def dump_seconds(self, checkpoint_bytes):
        return checkpoint_bytes / self.host_device_bandwidth

    def upload_seconds(self, checkpoint_bytes):
        return checkpoint_bytes / self.blob_bandwidth

    def download_seconds(self, checkpoint_bytes):
        return checkpoint_bytes / self.blob_bandwidth

    def transfer_seconds(self, checkpoint_bytes, src_region: Optional[str] = None,
                         dst_region: Optional[str] = None):
        """Blob round trip, weighted by the (source, destination) region
        pair when a topology is attached."""
        base = self.upload_seconds(checkpoint_bytes) \
            + self.download_seconds(checkpoint_bytes)
        if self.topology is None:
            return base
        return base * self.topology.transfer_factor(src_region, dst_region) \
            + self.topology.latency_seconds(src_region, dst_region)

    # ------------------------------------------------------------- events
    def preempt_seconds(self, checkpoint_bytes):
        """Quiesce + dump + upload: paid before the GPUs are released."""
        return self.scale * (self.barrier_seconds()
                             + self.dump_seconds(checkpoint_bytes)
                             + self.upload_seconds(checkpoint_bytes))

    def restore_seconds(self, checkpoint_bytes, src_region: Optional[str] = None,
                        dst_region: Optional[str] = None):
        """Download + rendezvous: paid before the first useful step.  A
        restore landing in a different region than the one that uploaded
        the checkpoint pays the pair's download tier, same as the
        download leg of a migration."""
        download = self.download_seconds(checkpoint_bytes)
        if self.topology is not None:
            download = download * self.topology.transfer_factor(
                src_region, dst_region) \
                + self.topology.latency_seconds(src_region, dst_region)
        return self.scale * (download + self.rendezvous_seconds)

    def migrate_seconds(self, checkpoint_bytes, src_region: Optional[str] = None,
                        dst_region: Optional[str] = None):
        """Full Table-5 path: the job is down for the whole round trip.
        A cross-region move pays the inter-region blob tier for the
        transfer leg (slower link + first-byte latency)."""
        return self.scale * (self.barrier_seconds()
                             + self.dump_seconds(checkpoint_bytes)
                             + self.transfer_seconds(checkpoint_bytes,
                                                     src_region, dst_region)
                             + self.rendezvous_seconds)

    def resize_seconds(self, checkpoint_bytes):
        """In-place splice swap: quiesce + re-rendezvous, state stays
        resident (no blob round trip)."""
        return self.scale * (self.barrier_seconds()
                             + self.rendezvous_seconds)

    def snapshot_seconds(self, checkpoint_bytes):
        """Online checkpoint while the job keeps its allocation: quiesce
        + dump + upload — the save side of a preemption, charged as
        downtime.  This is the Young–Daly ``delta`` the checkpoint
        cadence weighs against the domain failure rate."""
        return self.preempt_seconds(checkpoint_bytes)

    # --------------------------------------------------------- constructors
    @classmethod
    def free(cls) -> "CostModel":
        """All mechanisms free — the (dishonest) seed behaviour, kept for
        ablations."""
        return cls(scale=0.0)

    @classmethod
    def uniform(cls, migration_cost_seconds: float,
                preemption_cost_seconds: Optional[float] = None,
                restore_cost_seconds: Optional[float] = None,
                resize_cost_seconds: Optional[float] = None) -> "UniformCostModel":
        """Flat per-event charges, independent of checkpoint size."""
        return UniformCostModel(
            migration=migration_cost_seconds,
            preemption=preemption_cost_seconds,
            restore=restore_cost_seconds,
            resize=resize_cost_seconds)

    @classmethod
    def from_reports(cls, reports: Iterable, topology: Optional[RegionTopology] = None,
                     scale: float = 1.0) -> "CostModel":
        """Calibrate the derived model from measured ``MigrationReport``s.

        Closes the loop between ``core/migration.py`` (which measures the
        real barrier/dump/transfer/restore flow on this host) and the
        scheduler (which charges those costs fleet-wide): bandwidths are
        fitted as total-bytes / total-seconds over all reports, the
        barrier as mean per-minibatch wall time, the rendezvous as the
        mean measured restore.  Reports are duck-typed so analysis
        tooling can calibrate from serialized rows as well.

        When reports carry ``src_region``/``dst_region``, the fit is
        region-aware: the base blob bandwidth comes from intra-region
        (or region-blind) reports, and each measured cross-region pair
        gets its own fitted ``RegionLink`` in a synthesized
        ``RegionTopology`` — so the scheduler charges the slower WAN
        tiers it actually observed.  A ``topology`` passed explicitly is
        never overwritten by the fit.
        """
        reports = list(reports)
        if not reports:
            raise ValueError("from_reports needs at least one MigrationReport")

        def _pair(r) -> Optional[Tuple[str, str]]:
            src = getattr(r, "src_region", None)
            dst = getattr(r, "dst_region", None)
            if src is None or dst is None or src == dst:
                return None
            return (src, dst)

        def _blob_bw(rs) -> float:
            nbytes = float(sum(r.device_stored_bytes + r.host_stored_bytes
                               for r in rs))
            secs = float(sum(r.upload_seconds + r.download_seconds
                             for r in rs))
            return 2.0 * nbytes / max(secs, 1e-9)

        intra = [r for r in reports if _pair(r) is None]
        cross: Dict[Tuple[str, str], list] = {}
        for r in reports:
            pair = _pair(r)
            if pair is not None:
                cross.setdefault(pair, []).append(r)
        # base (intra-region) bandwidth from intra reports when any exist;
        # a purely cross-region report set falls back to the full pool
        base = intra if intra else reports
        base_bw = _blob_bw(base)
        if topology is None and cross:
            links = {
                pair: RegionLink(_blob_bw(rs)) for pair, rs in cross.items()
            }
            topology = RegionTopology(
                intra_bandwidth=base_bw,
                cross_bandwidth=min(lk.bandwidth for lk in links.values()),
                cross_latency_seconds=0.0,
                links=links)

        total_bytes = float(sum(r.device_stored_bytes + r.host_stored_bytes
                                for r in reports))
        dump_s = float(sum(r.dump_seconds for r in reports))
        n = len(reports)
        mb = max(1, round(sum(r.barrier_minibatches for r in reports) / n))
        mb_seconds = sum(r.barrier_seconds / max(r.barrier_minibatches, 1)
                         for r in reports) / n
        rendezvous = sum(r.restore_seconds for r in reports) / n
        return cls(
            blob_bandwidth=base_bw,
            host_device_bandwidth=total_bytes / max(dump_s, 1e-9),
            barrier_minibatches=mb,
            minibatch_seconds=mb_seconds,
            rendezvous_seconds=rendezvous,
            scale=scale,
            topology=topology)


@dataclasses.dataclass(frozen=True)
class UniformCostModel(CostModel):
    """Flat per-event costs (seconds), ignoring checkpoint size.

    ``CostModel.uniform(60.0)`` reproduces the paper's "tens of seconds"
    headline number as a single knob; ``CostModel.uniform(0.0)`` is the
    cost-free ablation.  Unset per-event costs derive from ``migration``
    (preempt + restore == migrate, resize = migration / 6), and the
    inherited ``scale`` knob applies here too.  When a topology is
    attached the flat migration charge is weighted by the region pair's
    transfer factor plus its latency (intra = 1.0 + 0s), so cross-region
    moves stay more expensive even in controlled uniform-cost
    experiments; a zero-cost model stays exactly zero.
    """

    migration: float = 60.0
    preemption: Optional[float] = None    # default: migration / 2
    restore: Optional[float] = None       # default: migration / 2
    resize: Optional[float] = None        # default: migration / 6

    def __post_init__(self):
        if self.preemption is None:
            object.__setattr__(self, "preemption", self.migration / 2)
        if self.restore is None:
            object.__setattr__(self, "restore", self.migration / 2)
        if self.resize is None:
            object.__setattr__(self, "resize", self.migration / 6)

    def preempt_seconds(self, checkpoint_bytes):
        return self.scale * self.preemption

    def restore_seconds(self, checkpoint_bytes, src_region: Optional[str] = None,
                        dst_region: Optional[str] = None):
        base = self.scale * self.restore
        if self.topology is None or base == 0:
            return base      # a free/flat-zero model stays exactly zero
        return base * self.topology.transfer_factor(src_region, dst_region) \
            + self.scale * self.topology.latency_seconds(src_region, dst_region)

    def migrate_seconds(self, checkpoint_bytes, src_region: Optional[str] = None,
                        dst_region: Optional[str] = None):
        base = self.scale * self.migration
        if self.topology is None or base == 0:
            return base      # a free/flat-zero model stays exactly zero
        return base * self.topology.transfer_factor(src_region, dst_region) \
            + self.scale * self.topology.latency_seconds(src_region, dst_region)

    def resize_seconds(self, checkpoint_bytes):
        return self.scale * self.resize


def default_checkpoint_bytes(demand_gpus: int,
                             state_bytes_per_gpu: int = 2 << 30,
                             host_bytes_per_worker: int = 8 << 20) -> int:
    """Estimate a job's deduped checkpoint size.

    Device state S_G is independent of the DP degree (content dedup,
    Table 4) but larger models ship more shards, so we anchor it to the
    job's model-parallel footprint; per-worker host state S_Cr scales
    with the worker count (§7.2).
    """
    model_shards = max(1, demand_gpus // 8)    # DP degree ~8 in the fleet mix
    return model_shards * state_bytes_per_gpu \
        + demand_gpus * host_bytes_per_worker


def defrag_worthwhile(cost_model: CostModel,
                      checkpoint_bytes: Iterable[int],
                      freed_gpus: int,
                      interval_seconds: float) -> bool:
    """Gate for a defragmentation move: consolidating a node's stranded
    fragments is worth it only when one scheduling interval of the freed
    capacity (GPU-seconds a queued gang could now use) outweighs the
    intra-cluster migrate downtime charged to every moved job."""
    cost = sum(cost_model.migrate_seconds(cb) for cb in checkpoint_bytes)
    return cost < float(freed_gpus) * float(interval_seconds)
