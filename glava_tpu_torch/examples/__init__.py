"""Example user modules of the port, to copy into a config root's
``modules/`` directory (``render.modules.load_user_modules``)."""
