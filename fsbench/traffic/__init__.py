"""Traffic generators: each makes one input of a cell from its seed."""
