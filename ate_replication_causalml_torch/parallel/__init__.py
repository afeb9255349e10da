"""Failure detection and classified retry for the port's shard loops
(:mod:`.retry`). The JAX package's mesh, artifact sharding and multihost
modules are not ported: the port runs on one device."""
