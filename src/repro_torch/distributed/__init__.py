"""Distribution of the port. ``sharding`` is the reference's sharding
policy (parameter, cache, batch and optimizer-state specs, and their
DTensor placements), which the fleet uses to place its parameters
(``fleet.region.place_fleet_params``) and ``launch.specs`` to place a
sharded step's inputs; ``spmd`` runs a sharded step's pieces on each
rank's local blocks."""
