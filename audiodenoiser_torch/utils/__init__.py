"""Instrumentation helpers."""
