"""The port's copy of ``repro.core``: HGC code construction, assignment,
runtime model and planners (numpy only; imports renamed)."""
