"""Training (PyTorch port of ``repro.train``): AdamW, the synthetic data
pipeline, the train step with gradient accumulation, checkpoints in the
reference's layout and the fault-tolerant loop."""
