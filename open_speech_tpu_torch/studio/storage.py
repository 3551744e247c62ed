"""Studio persistence: per-thread SQLite connections + schema.

Counterpart of ``open_speech_tpu/studio/storage.py`` with the same DDL,
column for column, so a studio database written by either package opens
in the other. The store belongs to the app that makes it
(``server/app.py:create_app``): ``Store(path)`` opens that file, and each
manager is given its store, so two apps in one process keep two databases.

Connections are THREAD-LOCAL, not one shared handle: the app runs
conversation/composer renders in executor threads concurrently with
event-loop manager calls (history logging, profile CRUD), and a shared
``check_same_thread=False`` connection lets one request's ``commit()``
persist another's half-finished multi-statement transaction (e.g. a failed
render's partial turn UPDATEs, or a torn ``set_default`` pair). WAL mode
gives concurrent readers + a single serialized writer per *connection*, so
one-connection-per-thread makes every manager call transactionally
isolated with zero changes at the call sites.
"""

from __future__ import annotations

import sqlite3
import threading
from pathlib import Path


class Store:
    """Lazily-opened thread-local SQLite handles (WAL, FKs, row factory)
    on the database file at ``path``."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self._local = threading.local()
        self._guard = threading.Lock()
        # bumped by close(): every thread's connection is stale after it
        self._generation = 0

    def connection(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            if getattr(self._local, "gen", -1) == self._generation:
                return conn
            conn.close()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        conn = sqlite3.connect(str(self.path))
        conn.row_factory = sqlite3.Row
        for pragma in (
            "journal_mode=WAL",
            "foreign_keys=ON",
            "busy_timeout=5000",
        ):
            conn.execute(f"PRAGMA {pragma}")
        self._local.conn = conn
        self._local.gen = self._generation
        return conn

    def bootstrap(self) -> None:
        conn = self.connection()
        for ddl in _TABLES:
            conn.executescript(ddl)
        conn.commit()

    def close(self) -> None:
        with self._guard:
            self._generation += 1
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


# Column-compatible with the reference schema; one statement per table.
_TABLES = (
    """
    create table if not exists profiles (
        id text primary key,
        name text not null unique,
        backend text not null,
        model text,
        voice text not null,
        speed real not null default 1.0,
        format text not null default 'mp3',
        blend text,
        reference_audio_id text,
        effects_json text,
        is_default integer not null default 0,
        created_at text not null,
        updated_at text not null
    );
    """,
    """
    create table if not exists history_entries (
        id text primary key,
        type text not null check(type in ('tts','stt')),
        created_at text not null,
        model text,
        voice text,
        speed real,
        format text,
        text_preview text,
        full_text text,
        input_filename text,
        output_path text,
        output_bytes integer,
        streamed integer not null default 0,
        meta_json text
    );
    create index if not exists idx_history_type_created
        on history_entries(type, created_at desc);
    """,
    """
    create table if not exists conversations (
        id text primary key,
        name text,
        created_at text not null,
        updated_at text not null,
        render_output_path text,
        meta_json text
    );
    """,
    """
    create table if not exists conversation_turns (
        id text primary key,
        conversation_id text not null,
        turn_index integer not null,
        speaker text not null,
        profile_id text,
        text text not null,
        audio_path text,
        duration_ms integer,
        effects_json text,
        created_at text not null,
        foreign key(conversation_id)
            references conversations(id) on delete cascade
    );
    create index if not exists idx_turns_conv
        on conversation_turns(conversation_id, turn_index);
    """,
    """
    create table if not exists compositions (
        id text primary key,
        name text,
        sample_rate integer not null default 24000,
        created_at text not null,
        updated_at text not null,
        render_output_path text,
        tracks_json text,
        meta_json text
    );
    """,
)

# kept for callers/tests that want the full DDL in one string
SCHEMA_SQL = "\n".join(_TABLES)
