"""Telemetry: metrics registry and lifecycle trace recorder (pure Python)."""
