"""Multi-device scaling: sharded BA, sharded place recognition.

The reference has no distributed layer (std::thread on one host,
SURVEY.md §2.9); this package is the invented equivalent: `shard_map`
over a `jax.sharding.Mesh`, collectives between the devices."""
