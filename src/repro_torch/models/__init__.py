"""Model zoo (dense family so far) over flat parameter segments."""
