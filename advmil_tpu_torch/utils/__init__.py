"""Host utilities: config scraping, I/O, run logging."""
