"""Distribution of the port. ``sharding`` holds the parameter half of
the reference's sharding policy, which the fleet uses to place its
parameters (``fleet.region.place_fleet_params``)."""
