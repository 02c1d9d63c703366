"""Checkpoint ingestion of the port: AWQ / GPTQ grouped int4 (``grouped.py``),
the float families BLOOM and MPT (``families.py``) and checkpoint
directories (``loader.py``: the safetensors reader, ``config_from_hf_dir``)."""
