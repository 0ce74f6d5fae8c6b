"""Serving for the port: the fixed-batch continuous-batching decode engine
and its request, slot and admission bookkeeping."""
