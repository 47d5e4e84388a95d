"""Offline preprocessing tools: graphs, patch clusters, patch coordinates."""
