"""The HTTP surface (aiohttp), imported only by `main.build_app`."""
