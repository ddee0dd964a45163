"""Wire types between the request pipeline and workers."""
