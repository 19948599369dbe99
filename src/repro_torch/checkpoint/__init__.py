"""Parameter layout shared with the reference's checkpoints."""
