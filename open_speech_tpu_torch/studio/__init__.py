"""Studio layer: SQLite storage, profiles, history, conversations, composer, voice library."""
