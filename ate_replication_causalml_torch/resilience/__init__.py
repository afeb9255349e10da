"""Resilience pieces of the port: so far the heartbeat registry and lane
bounds the sweep engine stamps (:mod:`.watchdog`)."""
