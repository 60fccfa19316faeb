"""Timing on the card."""
