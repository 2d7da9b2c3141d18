"""Serving: batched prefill + decode loops (ports `repro/serve`)."""
