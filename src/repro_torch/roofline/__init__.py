"""Roofline terms of the dry-run's steps, counted on the meta device."""
