"""Host-side simulation helpers: loss-proportional sampling and seeded
attackers (the port's own copies of ``fedtpu.sim.sampling`` and
``fedtpu.sim.adversary``)."""
