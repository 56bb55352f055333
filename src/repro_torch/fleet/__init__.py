"""Fleet-scale serving: region simulation over engine replicas.

The load is open-loop and the serving plane is a fleet:

  * ``workload`` — seeded Poisson / diurnal-modulated arrival processes
    spawning whole incident sessions (``IncidentSession``) at a
    configurable offered rate, with stochastic intra-session modality
    lags carried as explicit per-event arrival sequences through
    ``core.episodes.async_episode(times=...)``; the same draws as the
    reference's, event for event.
  * ``region`` — ``RegionSim``: N ``EMSServeEngine`` replicas built
    from ONE ``build_engine`` spec over parameters placed on a device
    mesh through the ``distributed.sharding`` policy, a consistent-hash
    + least-loaded session router, and a shared simulated clock (flush
    cost = measured wall seconds of the real calls on the card, flush
    start gated on data availability).
  * ``admission`` — deadline/queue-depth admission control with
    hysteresis; overload sheds NEW sessions to the on-glass provisional
    path (``GlassShedPath``) where they receive ``degraded``-tagged
    partials instead of queueing the backlog to death.

Launcher: ``python -m repro_torch.launch.serve --fleet RATE --replicas N``.
"""
from .admission import AdmissionController, AdmissionPolicy, AdmitAll  # noqa: F401
from .region import (ConsistentHashRouter, DegradedRecord,  # noqa: F401
                     FleetMesh, GlassShedPath, RegionSim, fleet_mesh,
                     place_fleet_params)
from .workload import (IncidentSession, diurnal_rate,  # noqa: F401
                       diurnal_times, generate_workload, merge_sessions,
                       poisson_times)
