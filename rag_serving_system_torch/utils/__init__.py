"""Host-side helpers: the memo LRU, stage timers and the RESP client."""
