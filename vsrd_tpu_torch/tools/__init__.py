"""Host tools of the port."""
