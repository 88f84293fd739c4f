"""Training: the optimizer, checkpoints, the data pipeline (ETL → token
batches) and the trainer, twins of the JAX package's ``repro.train``."""
