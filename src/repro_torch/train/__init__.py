"""Training: the optimizers (``optimizer``), the train step
(``train_step``), checkpoints (``checkpoint``) and the synthetic data
stream (``data``). Port of ``repro.train``."""
