"""Core types the commit-verification slice needs (ref: types/)."""
