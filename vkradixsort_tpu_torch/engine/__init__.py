"""Configuration and device discovery."""
