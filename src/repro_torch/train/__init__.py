"""Training: AdamW with a cosine schedule (``optimizer``) and the train
step and loop (``loop``).  Port of ``repro.train``."""
