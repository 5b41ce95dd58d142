from .cache import LRUCache, NopCache, RankCache, new_cache
from .field import BSIGroup, Field, FieldOptions
from .fragment import Fragment, SHARD_WIDTH
from .holder import Holder
from .index import EXISTENCE_FIELD_NAME, Index
from .row import Row
from .view import VIEW_STANDARD, View, view_bsi_name
