"""De Bruijn graph construction and contig traversal on the device."""
