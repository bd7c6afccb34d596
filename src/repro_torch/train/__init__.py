"""Training: AdamW, the train step and the single-host trainer
(counterpart of ``repro/train``)."""
