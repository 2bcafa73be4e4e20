"""Core types the commit and light-header verification slices need (ref: types/)."""
