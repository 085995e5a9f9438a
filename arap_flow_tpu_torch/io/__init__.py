"""Host IO: .flo codec, constraint files, PNG/mask IO (numpy only)."""
