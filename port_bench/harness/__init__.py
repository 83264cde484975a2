"""The benchmark's general machinery: finding a cell's files by name, the run's
context and result line, the device trace and the card's peaks."""
