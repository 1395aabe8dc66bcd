"""Training substrate of the port: AdamW, gradient compression, the
synthetic data pipeline, checkpoints and the straggler monitor, with the
reference's (``repro.train``) names and state keys."""
