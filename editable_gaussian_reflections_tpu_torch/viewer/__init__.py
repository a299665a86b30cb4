"""The viewer: ViewerState (state.py), the websocket RenderService
(service.py) and the tkinter LOCAL shell (local.py)."""
