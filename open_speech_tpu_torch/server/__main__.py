"""``python -m open_speech_tpu_torch.server``: start the speech server on
``OS_HOST:OS_PORT`` (TLS unless ``OS_SSL_ENABLED=false``)."""

from open_speech_tpu_torch.server.app import main

if __name__ == "__main__":
    main()
