"""Step builders.  The named-sharding rules of the JAX package's
``repro.distributed`` wait for ROADMAP modules item 11; the train step
runs on one device."""
