"""Serving steps over the models (``serve_step``): port of
``repro.serve``."""
