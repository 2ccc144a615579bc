"""Measurement tools: the A/B of kernel D's block shape (needs a card)
and the timed class path (``class_path``, on any device)."""
