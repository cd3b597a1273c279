"""Constrained decoding (counterpart of localai_tpu/functions): the GBNF
matcher and the grammar tables the engine serves `GenRequest.grammar`
through (matcher.py). The JSON-schema and tool-call grammar generators stay
with the control plane, which sends the backend a finished GBNF string."""
