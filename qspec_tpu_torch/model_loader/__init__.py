"""Checkpoint ingestion of the port: AWQ / GPTQ grouped int4 (``grouped.py``)."""
