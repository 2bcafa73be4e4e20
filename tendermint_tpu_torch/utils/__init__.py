"""Host utilities the verification slice needs."""
