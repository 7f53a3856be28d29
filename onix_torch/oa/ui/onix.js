/* onix analyst dashboard — shared renderer for flow/dns/proxy.
 *
 * Data contract (written by `onix oa`, served by `onix serve`):
 *   /data/<type>/dates.json                      available dates
 *   /data/<type>/<yyyymmdd>/suspicious.json      scored+enriched rows
 *   /data/<type>/<yyyymmdd>/summary.json         tiles/histogram/timeline
 *   /data/<type>/<yyyymmdd>/graph.json           network nodes+links
 * Labels POST to /feedback as {datatype, date, rows:[{ip,word,rank,score,label}]}.
 * Date routing uses the #date=YYYY-MM-DD hash like the reference UI.
 */
"use strict";

const TYPE = window.ONIX_TYPE;
const COLS = {
  flow: ["rank", "score", "treceived", "sip", "dip", "sport", "dport",
         "proto", "ipkt", "ibyt", "src_geo_country", "dst_geo_country",
         "dst_rep"],
  dns: ["rank", "score", "frame_time", "ip_dst", "dns_qry_name", "domain",
        "name_entropy", "dns_qry_type", "dns_qry_rcode", "geo_country",
        "rep"],
  proxy: ["rank", "score", "p_time", "clientip", "host", "reqmethod",
          "uripath", "respcode", "useragent", "geo_country", "rep"],
};
const REP_COLS = new Set(["rep", "src_rep", "dst_rep"]);
// Per-row event-time field (the same columns engine.py's summary uses).
const TIME_KEYS = { flow: "treceived", dns: "frame_time", proxy: "p_time" };
// Which row fields correspond to a graph edge's (source, target) — must
// match onix/oa/engine.py _graph().
const EDGE_KEYS = {
  flow: ["sip", "dip"],
  dns: ["ip_dst", "domain"],
  proxy: ["clientip", "host"],
};
const labels = new Map();   // rank -> label
let allRows = [];           // current date's suspicious rows
let currentDate = null;
let graphMode = "chord";    // "chord" | "list"
let lastGraph = null;
let tableSort = null;       // {col, dir} | null (null = rank order)
let tableFilter = "";       // substring filter over every rendered cell

function hashDate() {
  const m = location.hash.match(/date=(\d{4}-\d{2}-\d{2})/);
  return m ? m[1] : null;
}
function dayDir(date) { return date.replaceAll("-", ""); }
async function getJSON(url) {
  const r = await fetch(url);
  if (!r.ok) throw new Error(`${url}: ${r.status}`);
  return r.json();
}
function el(tag, attrs = {}, text = null) {
  const e = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) e.setAttribute(k, v);
  if (text !== null) e.textContent = text;
  return e;
}
function svgEl(tag, attrs = {}) {
  const e = document.createElementNS("http://www.w3.org/2000/svg", tag);
  for (const [k, v] of Object.entries(attrs)) e.setAttribute(k, v);
  return e;
}
function fmtScore(s) { return Number(s).toExponential(2); }


// Campaign suspects: document topic-rarity ranking (summary.json
// suspicious_clients, written by the round-5 scoring run). Event-level
// word rarity fades on sustained homogeneous campaigns; these are the
// clients whose token mass rides topics almost nobody else uses.
function renderClients(sum) {
  const list = sum.suspicious_clients || [];
  const panel = document.getElementById("clients-panel");
  if (!panel) return;
  if (!list.length) { panel.hidden = true; return; }
  panel.hidden = false;
  const tbl = el("table", { class: "mini" });
  const head = el("tr");
  ["#", "client", "topic rarity", "tokens"].forEach(
    h => head.append(el("th", {}, h)));
  tbl.append(head);
  list.forEach((c, i) => {
    const tr = el("tr", { class: "clickable" });
    tr.append(el("td", {}, String(i + 1)),
              el("td", {}, c.client),
              el("td", {}, Number(c.topic_rarity).toFixed(3)),
              el("td", {}, String(c.n_tokens)));
    tr.addEventListener("click", () => {
      // Results rows attribute each event to its achieving document
      // ("ip" column) — the same id space as the client ranking. An
      // ABSORBED campaign has no event-level rows by definition; say
      // so instead of presenting a silently empty drill.
      const mine = allRows.filter(r => String(r.ip) === c.client);
      openDrill(mine.length
        ? `client ${c.client}`
        : `client ${c.client} — no event-level hits (campaign ` +
          `absorbed into its own topic; evidence is the rarity ` +
          `score + clients.csv)`, mine);
    });
    tbl.append(tr);
  });
  document.getElementById("clients").replaceChildren(tbl);
}

function renderTiles(sum) {
  const run = sum.run || {};
  const tiles = [
    ["suspicious", sum.n_results],
    ["events scanned", run.n_events ?? "—"],
    ["documents (IPs)", run.n_docs ?? "—"],
    ["vocabulary", run.n_vocab ?? "—"],
    ["min score", sum.score_min == null ? "—" : fmtScore(sum.score_min)],
    ["events/sec", run.events_per_sec ?? "—"],
    ["run wall (s)", run.wall_seconds ?? "—"],
  ];
  const box = document.getElementById("tiles");
  box.replaceChildren(...tiles.map(([l, v]) => {
    const t = el("div", { class: "tile" });
    t.append(el("div", { class: "v" }, String(v)), el("div", { class: "l" }, l));
    return t;
  }));
  // Model-convergence tile: the per-sweep log-likelihood series from the
  // run manifest (the reference's likelihood.dat) as a sparkline, so a
  // non-converged model is visible right where the ranking is read.
  const ll = run.ll_series || [];
  if (ll.length >= 2) {
    const t = el("div", { class: "tile", title: "log-likelihood per sweep" });
    // sparkline() draws non-negative bar heights; log-likelihoods are
    // negative, so normalize the series into the 0.1..1 range — the
    // floor keeps a flat, already-converged series visibly non-empty.
    const lo = Math.min(...ll), hi = Math.max(...ll);
    const norm = ll.map(v => 0.1 + 0.9 * ((v - lo) / (hi - lo || 1)));
    const last = ll[ll.length - 1];
    t.append(sparkline(norm), el("div", { class: "l" },
                                 `convergence (final ll ${last.toFixed(3)})`));
    box.append(t);
  }
}

function renderBars(elId, values, titleFn) {
  const svgW = 460, svgH = 120, pad = 4;
  const box = document.getElementById(elId);
  const svg = svgEl("svg", { viewBox: `0 0 ${svgW} ${svgH}`, width: "100%" });
  const max = Math.max(1, ...values);
  const bw = (svgW - pad * 2) / values.length;
  values.forEach((v, i) => {
    const h = (svgH - 18) * v / max;
    const r = svgEl("rect", {
      class: "bar", x: pad + i * bw + 0.5, width: Math.max(bw - 1, 1),
      y: svgH - 14 - h, height: h,
    });
    r.append(svgEl("title"));
    r.querySelector("title").textContent = titleFn(i, v);
    svg.append(r);
  });
  const t0 = svgEl("text", { x: pad, y: svgH - 2 });
  t0.textContent = titleFn(0, values[0]).split(":")[0];
  const t1 = svgEl("text", { x: svgW - 60, y: svgH - 2 });
  t1.textContent = titleFn(values.length - 1, values.at(-1)).split(":")[0];
  svg.append(t0, t1);
  box.replaceChildren(svg);
}

function edgeTitle(l) {
  return `${l.source} → ${l.target} (${l.weight} events, ` +
    `min score ${fmtScore(l.min_score)})`;
}

function edgeOf(l, links, maxW) {
  // Shared edge decoration: hotness by score, width by weight, tooltip,
  // and the graph → rows drill-down on click.
  return {
    cls: "edge" + (l.min_score <= links[0].min_score * 10 ? " hot" : ""),
    width: Math.max(1, 4 * l.weight / maxW),
    attach(shape) {
      const t = svgEl("title");
      t.textContent = edgeTitle(l);
      shape.append(t);
      shape.addEventListener("click", () => showDrill(l));
    },
  };
}

function renderBipartite(links, box) {
  const srcs = [...new Set(links.map(l => l.source))];
  const dsts = [...new Set(links.map(l => l.target))];
  const rowH = 14, svgW = 460, pad = 110;
  const svgH = Math.max(srcs.length, dsts.length) * rowH + 24;
  const svg = svgEl("svg", { viewBox: `0 0 ${svgW} ${svgH}`, width: "100%" });
  const yOf = (list, id) => 16 + list.indexOf(id) * rowH;
  const maxW = Math.max(...links.map(l => l.weight));
  for (const l of links) {
    const deco = edgeOf(l, links, maxW);
    const line = svgEl("line", {
      class: deco.cls,
      x1: pad, y1: yOf(srcs, l.source),
      x2: svgW - pad, y2: yOf(dsts, l.target),
      "stroke-width": deco.width,
    });
    deco.attach(line);
    svg.append(line);
  }
  srcs.forEach(s => {
    const t = svgEl("text", { class: "node", x: pad - 6, y: yOf(srcs, s) + 3,
                              "text-anchor": "end" });
    t.textContent = s; svg.append(t);
  });
  dsts.forEach(d => {
    const t = svgEl("text", { class: "node", x: svgW - pad + 6,
                              y: yOf(dsts, d) + 3 });
    t.textContent = d; svg.append(t);
  });
  box.replaceChildren(svg);
}

function renderChord(links, box) {
  // Dependency-free chord-style view: every endpoint on a circle,
  // edges as quadratic curves pulled toward the center — the
  // reference's flow chord dashboard re-imagined without D3
  // (reference README.md:45-48,55-56).
  const ids = [...new Set(links.flatMap(l => [l.source, l.target]))];
  const svgW = 460, svgH = 460, cx = svgW / 2, cy = svgH / 2;
  const r = Math.min(cx, cy) - 76;
  const pos = new Map(ids.map((id, i) => {
    const a = (2 * Math.PI * i) / ids.length - Math.PI / 2;
    return [id, { x: cx + r * Math.cos(a), y: cy + r * Math.sin(a), a }];
  }));
  const svg = svgEl("svg", { viewBox: `0 0 ${svgW} ${svgH}`, width: "100%" });
  const maxW = Math.max(...links.map(l => l.weight));
  for (const l of links) {
    const p1 = pos.get(l.source), p2 = pos.get(l.target);
    const deco = edgeOf(l, links, maxW);
    const path = svgEl("path", {
      class: deco.cls, fill: "none",
      d: `M ${p1.x.toFixed(1)} ${p1.y.toFixed(1)} ` +
         `Q ${cx} ${cy} ${p2.x.toFixed(1)} ${p2.y.toFixed(1)}`,
      "stroke-width": deco.width,
    });
    deco.attach(path);
    svg.append(path);
  }
  for (const id of ids) {
    const p = pos.get(id);
    const deg = (p.a * 180) / Math.PI;
    const flip = deg > 90 || deg < -90;
    const t = svgEl("text", {
      class: "node",
      x: 0, y: 0,
      "text-anchor": flip ? "end" : "start",
      transform: `translate(${(cx + (r + 6) * Math.cos(p.a)).toFixed(1)},` +
        `${(cy + (r + 6) * Math.sin(p.a)).toFixed(1)}) ` +
        `rotate(${(flip ? deg + 180 : deg).toFixed(1)})`,
    });
    t.textContent = id;
    svg.append(t);
  }
  box.replaceChildren(svg);
}

function renderGraph(graph) {
  lastGraph = graph;
  const box = document.getElementById("graph");
  const links = [...graph.links].sort((a, b) => a.min_score - b.min_score)
    .slice(0, 60);
  if (!links.length) { box.replaceChildren(el("div", { class: "empty" }, "no edges")); return; }
  if (graphMode === "chord") renderChord(links, box);
  else renderBipartite(links, box);
  const btn = document.getElementById("graph-mode");
  btn.textContent = graphMode === "chord" ? "bipartite view" : "chord view";
  btn.onclick = () => {
    graphMode = graphMode === "chord" ? "list" : "chord";
    renderGraph(lastGraph);
  };
}

function openDrill(title, rows, { progression = false } = {}) {
  // Rows → label without touching the main table's ordering: render the
  // filtered rows in the drill panel with the same label controls
  // (shared `labels` map, same Save button). `progression: true` adds
  // the actor's incident-progression lanes (storyboard drills).
  document.getElementById("drill-title").textContent =
    `${title} — ${rows.length} suspicious row${rows.length === 1 ? "" : "s"}`;
  renderTable(rows, currentDate, document.getElementById("drill-table"));
  document.getElementById("drill-progression").replaceChildren();
  if (progression) renderProgression(rows);
  const panel = document.getElementById("drill-panel");
  panel.hidden = false;
  panel.scrollIntoView({ behavior: "smooth", block: "nearest" });
  document.getElementById("drill-clear").onclick = () => {
    panel.hidden = true;
  };
}

function showDrill(link) {
  const [ks, kt] = EDGE_KEYS[TYPE];
  const rows = allRows.filter(
    r => String(r[ks]) === String(link.source) &&
         String(r[kt]) === String(link.target));
  openDrill(`${link.source} → ${link.target}`, rows);
}

function hourFracOf(row) {
  // "2016-07-08 13:45:00" or "13:45:00" -> 13.75; null when unparsable.
  const m = String(row[TIME_KEYS[TYPE]] ?? "").match(/(\d{1,2}):(\d{2})/);
  return m ? Number(m[1]) + Number(m[2]) / 60 : null;
}

function renderEventTimeline(rows) {
  // Per-EVENT timeline (VERDICT r2 next #9): every suspicious row as a
  // dot at (time of day, score on a log axis). The hourly bars above
  // aggregate; this is the analyst's beacon-spotting view — periodic
  // dots in a horizontal line are a beacon, a burst is an exfil
  // window. Click a dot to open that event in the drill panel.
  const box = document.getElementById("event-timeline");
  const pts = rows.map(r => ({ r, h: hourFracOf(r), s: Number(r.score) }))
    .filter(p => p.h !== null && p.s > 0);
  if (!pts.length) {
    box.replaceChildren(el("div", { class: "empty" }, "no events"));
    return;
  }
  const svgW = 460, svgH = 150, padL = 34, padB = 16, padT = 6;
  const svg = svgEl("svg", { viewBox: `0 0 ${svgW} ${svgH}`, width: "100%" });
  const lo = Math.min(...pts.map(p => p.s)), hi = Math.max(...pts.map(p => p.s));
  const ll = Math.log(lo), lh = Math.log(hi * 1.0001);
  const yOf = s => padT + (svgH - padT - padB)
    * (1 - (Math.log(s) - ll) / (lh - ll || 1));
  const xOf = h => padL + (svgW - padL - 6) * h / 24;
  hourGrid(svg, xOf, padT, svgH - padB, svgH);
  [lo, hi].forEach(s => {
    const t = svgEl("text", { x: 1, y: yOf(s) + 3 });
    t.textContent = fmtScore(s);
    svg.append(t);
  });
  const hotCut = hotCutOf(pts);
  for (const p of pts) {
    const c = svgEl("circle", {
      class: "evt" + (p.s <= hotCut ? " hot" : ""),
      cx: xOf(p.h).toFixed(1), cy: yOf(p.s).toFixed(1), r: 2.5,
    });
    const t = svgEl("title");
    t.textContent = `rank ${p.r.rank} · score ${fmtScore(p.s)} · ` +
      `${p.r[TIME_KEYS[TYPE]]}`;
    c.append(t);
    c.addEventListener("click", () => openDrill(`event rank ${p.r.rank}`,
                                                [p.r]));
    svg.append(c);
  }
  box.replaceChildren(svg);
}

function fmtBytes(n) {
  for (const u of ["B", "KB", "MB", "GB", "TB"]) {
    if (n < 1024 || u === "TB") return `${n.toFixed(n < 10 ? 1 : 0)} ${u}`;
    n /= 1024;
  }
}

function renderGeo(geo) {
  // World-map view of the suspicious endpoints (the reference OA's
  // globe/map visualization re-rendered dependency-free): equirect
  // projection with a graticule, dot hotness = lowest-score decile,
  // click → that row in the drill panel. Beside it, the per-country
  // rollup as proportional bars.
  const box = document.getElementById("geo-map");
  const pts = (geo && geo.points) || [];
  if (!pts.length) {
    box.replaceChildren(el("div", { class: "empty" },
                           "no geolocatable endpoints"));
    document.getElementById("geo-countries").replaceChildren();
    return;
  }
  const svgW = 460, svgH = 240, padL = 26, padT = 6, padB = 14;
  const svg = svgEl("svg", { viewBox: `0 0 ${svgW} ${svgH}`, width: "100%" });
  const xOf = lon => padL + (svgW - padL - 6) * (lon + 180) / 360;
  const yOf = lat => padT + (svgH - padT - padB) * (90 - lat) / 180;
  for (let lon = -180; lon <= 180; lon += 60) {
    svg.append(svgEl("line", { class: "grid", x1: xOf(lon), x2: xOf(lon),
                               y1: yOf(90), y2: yOf(-90) }));
    const t = svgEl("text", { x: xOf(lon) - 10, y: svgH - 2 });
    t.textContent = `${lon}°`;
    svg.append(t);
  }
  for (let lat = -60; lat <= 60; lat += 30) {
    svg.append(svgEl("line", {
      class: "grid" + (lat === 0 ? " grid-eq" : ""),
      x1: xOf(-180), x2: xOf(180), y1: yOf(lat), y2: yOf(lat) }));
    const t = svgEl("text", { x: 1, y: yOf(lat) + 3 });
    t.textContent = `${lat}°`;
    svg.append(t);
  }
  const sorted = [...pts].sort((a, b) => a.score - b.score);
  const hotCut = sorted[Math.max(0, Math.floor(sorted.length / 10) - 1)].score;
  for (const p of pts) {
    const c = svgEl("circle", {
      class: "evt" + (p.score <= hotCut ? " hot" : ""),
      cx: xOf(p.lon).toFixed(1), cy: yOf(p.lat).toFixed(1), r: 3,
    });
    const t = svgEl("title");
    t.textContent = `${p.id} (${p.kind}) · ${p.country} · rank ${p.rank} · ` +
      `score ${fmtScore(p.score)}`;
    c.append(t);
    c.addEventListener("click", () => openDrill(
      `${p.id} (${p.country})`, allRows.filter(r => r.rank === p.rank)));
    svg.append(c);
  }
  box.replaceChildren(svg);
  const cbox = document.getElementById("geo-countries");
  const rows = (geo.countries || []).slice(0, 8);
  const maxN = Math.max(1, ...rows.map(r => r.n));
  cbox.replaceChildren(...rows.map(r => {
    const line = el("div", { class: "country-row" });
    const bar = el("div", { class: "country-bar" });
    bar.style.width = `${Math.max(2, 100 * r.n / maxN)}%`;
    line.append(
      el("span", { class: "country-name" }, r.country), bar,
      el("span", { class: "country-n",
                   title: `min score ${fmtScore(r.min_score)}` },
         String(r.n)));
    return line;
  }));
}

function renderIngest(ing, sum) {
  // Store-volume view of the day (the reference OA suite's
  // ingest-summary page): what the pipeline actually ingested, against
  // which the suspicious handful is read — README.md:42's "billion of
  // events to a few thousands" as a visible ratio.
  const tiles = document.getElementById("ingest-tiles");
  const hbox = document.getElementById("ingest-hourly");
  if (!ing || !ing.available) {
    tiles.replaceChildren(el("div", { class: "empty" },
                             "no store partition for this day"));
    hbox.replaceChildren();
    return;
  }
  const nSus = sum.n_results || 0;
  const ratio = nSus ? Math.round(ing.rows_total / nSus) : null;
  const cells = [
    ["events in store", ing.rows_total.toLocaleString()],
    ["part files", ing.n_parts],
    ["on disk", fmtBytes(ing.bytes_total)],
    ["filtered to", ratio ? `1 in ${ratio.toLocaleString()}` : "—"],
  ];
  tiles.replaceChildren(...cells.map(([l, v]) => {
    const t = el("div", { class: "tile" });
    t.append(el("div", { class: "v" }, String(v)),
             el("div", { class: "l" }, l));
    return t;
  }));
  if (ing.hourly && ing.hourly.some(v => v > 0)) {
    renderBars("ingest-hourly", ing.hourly,
      (i, v) => `${String(i).padStart(2, "0")}:00: ` +
        `${v.toLocaleString()} ingested`);
  } else {
    // hourly_skipped says WHY the engine left hourly null — a small
    // day without timestamps must not read as a volume problem.
    const why = ing.hourly_skipped === "too_large"
      ? "hourly profile skipped (day too large — totals from metadata)"
      : ing.hourly_skipped === "no_timestamps"
        ? "hourly profile unavailable (partition has no timestamp column)"
        : "no hourly profile";
    hbox.replaceChildren(el("div", { class: "empty" }, why));
  }
}

function sparkline(values, w = 120, h = 26) {
  const svg = svgEl("svg", { viewBox: `0 0 ${w} ${h}`, class: "spark" });
  const max = Math.max(1, ...values);
  const bw = w / values.length;
  values.forEach((v, i) => {
    const bh = (h - 2) * v / max;
    svg.append(svgEl("rect", {
      class: "bar", x: i * bw + 0.5, width: Math.max(bw - 1, 0.5),
      y: h - bh, height: bh,
    }));
  });
  return svg;
}

function hourGrid(svg, xOf, yTop, yBot, svgH) {
  // Shared 6-hour grid + HH:00 labels (event timeline + progression).
  for (let hh = 0; hh <= 24; hh += 6) {
    svg.append(svgEl("line", { class: "grid", x1: xOf(hh), x2: xOf(hh),
                               y1: yTop, y2: yBot }));
    const t = svgEl("text", { x: xOf(hh) - 8, y: svgH - 2 });
    t.textContent = `${String(hh).padStart(2, "0")}:00`;
    svg.append(t);
  }
}

function hotCutOf(pts) {
  // Lowest-score decile — the shared "most suspicious" emphasis.
  const sorted = [...pts].sort((a, b) => a.s - b.s);
  return sorted[Math.max(0, Math.floor(sorted.length / 10) - 1)].s;
}

function renderProgression(rows) {
  // Incident progression for one actor (the reference threat
  // investigation's progression tree, README.md:45-48): the actor's
  // suspicious events as time-ordered dots on one lane per peer,
  // most-suspicious peer first — beacon trains and lateral spread read
  // directly off the lanes. Rendered inside the drill panel when a
  // storyboard card opens.
  const box = document.getElementById("drill-progression");
  const [, kt] = EDGE_KEYS[TYPE];
  const pts = rows.map(r => ({ r, h: hourFracOf(r), peer: String(r[kt]),
                               s: Number(r.score) }))
    .filter(p => p.h !== null);
  if (pts.length < 2) { box.replaceChildren(); return; }
  const byPeer = new Map();
  for (const p of pts) {
    if (!byPeer.has(p.peer)) byPeer.set(p.peer, []);
    byPeer.get(p.peer).push(p);
  }
  const lanes = [...byPeer.entries()]
    .sort((a, b) => Math.min(...a[1].map(p => p.s))
                  - Math.min(...b[1].map(p => p.s)))
    .slice(0, 12);
  const rowH = 16, padL = 130, svgW = 460, padB = 14;
  const svgH = lanes.length * rowH + padB + 6;
  const svg = svgEl("svg", { viewBox: `0 0 ${svgW} ${svgH}`,
                             width: "100%", class: "progression" });
  const xOf = h => padL + (svgW - padL - 6) * h / 24;
  hourGrid(svg, xOf, 2, svgH - padB, svgH);
  const hotCut = hotCutOf(pts);
  lanes.forEach(([peer, ps], i) => {
    const y = 10 + i * rowH;
    const label = svgEl("text", { class: "node", x: padL - 6, y: y + 3,
                                  "text-anchor": "end" });
    label.textContent = peer;
    svg.append(label);
    const hs = ps.map(p => p.h);
    svg.append(svgEl("line", { class: "lane", y1: y, y2: y,
                               x1: xOf(Math.min(...hs)),
                               x2: xOf(Math.max(...hs)) }));
    for (const p of ps) {
      const c = svgEl("circle", {
        class: "evt" + (p.s <= hotCut ? " hot" : ""),
        cx: xOf(p.h).toFixed(1), cy: y, r: 3,
      });
      const t = svgEl("title");
      t.textContent = `${peer} · rank ${p.r.rank} · ` +
        `score ${fmtScore(p.s)} · ${p.r[TIME_KEYS[TYPE]]}`;
      c.append(t);
      svg.append(c);
    }
  });
  box.replaceChildren(svg);
}

function renderStoryboard(sb) {
  // The reference's threat storyboard (README.md:45-48) as cards: each
  // actor's narrative, activity sparkline, top peers; click → that
  // actor's rows in the drill panel for labeling.
  const box = document.getElementById("storyboard");
  const threats = (sb && sb.threats) || [];
  if (!threats.length) {
    box.replaceChildren(el("div", { class: "empty" }, "no threats"));
    return;
  }
  box.replaceChildren(...threats.map(t => {
    const card = el("div", { class: "story-card" });
    const head = el("div", { class: "story-head" });
    head.append(el("span", { class: "story-entity" }, t.entity),
                el("span", { class: "story-count" },
                   `${t.n_events} ev · min ${fmtScore(t.score_min)}`));
    const spark = sparkline(t.hourly || []);
    const story = el("div", { class: "story-text" }, t.story || "");
    const peers = el("div", { class: "story-peers" });
    (t.peers || []).forEach(p => peers.append(
      el("span", { class: "chip" }, `${p.id} ×${p.count}`)));
    card.append(head, spark, story, peers);
    card.addEventListener("click", () => {
      const set = new Set(t.ranks || []);
      openDrill(`threat ${t.entity}`,
                allRows.filter(r => set.has(r.rank)),
                { progression: true });
    });
    return card;
  }));
}

function viewRows(rows) {
  // Analyst table controls: substring filter over the rendered cells,
  // then column sort (numeric when both sides parse). Applied to the
  // MAIN table only — drill panels show their caller's exact rows.
  let out = rows;
  if (tableFilter) {
    const q = tableFilter.toLowerCase();
    const cols = COLS[TYPE];
    out = out.filter(r => cols.some(
      c => String(r[c] ?? "").toLowerCase().includes(q)));
  }
  if (tableSort) {
    const { col, dir } = tableSort;
    // ONE comparison mode for the whole column (numeric only when every
    // non-empty cell parses — a per-pair mode switch is intransitive and
    // makes Array.sort's result unspecified); empty cells always sort
    // last regardless of direction.
    const numeric = out.every(r => {
      const v = r[col];
      return v == null || v === "" || !Number.isNaN(Number(v));
    });
    out = [...out].sort((a, b) => {
      const x = a[col], y = b[col];
      const xm = x == null || x === "", ym = y == null || y === "";
      if (xm || ym) return xm && ym ? a.rank - b.rank : (xm ? 1 : -1);
      const cmp = numeric ? Number(x) - Number(y)
                          : String(x).localeCompare(String(y));
      return dir * cmp || a.rank - b.rank;
    });
  }
  return out;
}

function renderMainTable() {
  const shown = viewRows(allRows);
  const counter = document.getElementById("row-count");
  counter.textContent = shown.length === allRows.length
    ? `${allRows.length} rows`
    : `${shown.length} / ${allRows.length} rows`;
  renderTable(shown, currentDate);
}

function renderTable(rows, date, table = null) {
  const isMain = table === null;
  table = table || document.getElementById("sus-table");
  const cols = COLS[TYPE].filter(c => rows.length === 0 || c in rows[0]);
  const thead = el("thead");
  const hr = el("tr");
  cols.forEach(c => {
    const mark = (isMain && tableSort && tableSort.col === c)
      ? (tableSort.dir > 0 ? " ▲" : " ▼") : "";
    const th = el("th", isMain ? { class: "sortable" } : {}, c + mark);
    if (isMain) th.addEventListener("click", () => {
      tableSort = (tableSort && tableSort.col === c && tableSort.dir > 0)
        ? { col: c, dir: -1 }
        : (tableSort && tableSort.col === c) ? null : { col: c, dir: 1 };
      renderMainTable();
    });
    hr.append(th);
  });
  hr.append(el("th", {}, "sev"));
  thead.append(hr);
  const tbody = el("tbody");
  for (const row of rows) {
    const tr = el("tr");
    for (const c of cols) {
      const td = el("td", { class: c === "score" ? "score" : "" });
      let v = row[c];
      if (c === "score") v = fmtScore(v);
      td.textContent = v == null ? "" : v;
      if (REP_COLS.has(c)) td.className = `rep-${row[c]}`;
      td.title = row[c] == null ? "" : String(row[c]);
      tr.append(td);
    }
    const sel = el("select");
    [["0", "—"], ["1", "high"], ["2", "med"], ["3", "benign"]].forEach(
      ([v, t]) => sel.append(el("option", { value: v }, t)));
    sel.value = String(row.sev ?? 0);
    sel.addEventListener("change", () => {
      // Mutate the shared row object so the main table and a drill
      // panel rendering the same row stay consistent on re-render.
      row.sev = Number(sel.value);
      if (sel.value === "0") labels.delete(row.rank);
      else labels.set(row.rank, {
        ip: row.ip, word: row.word, rank: row.rank, score: row.score,
        label: Number(sel.value),
      });
      document.getElementById("save").disabled = labels.size === 0;
    });
    const labelTd = el("td");
    labelTd.append(sel);
    tr.append(labelTd);
    tbody.append(tr);
  }
  table.replaceChildren(thead, tbody);
  document.getElementById("save").onclick = async () => {
    const status = document.getElementById("status");
    try {
      const r = await fetch("/feedback", {
        method: "POST", headers: { "Content-Type": "application/json" },
        body: JSON.stringify({ datatype: TYPE, date,
                               rows: [...labels.values()] }),
      });
      const body = await r.json();
      if (!r.ok) throw new Error(body.error || r.status);
      status.textContent = `saved ${body.n} labels — consumed by the next run`;
      status.className = "ok";
      labels.clear();
      document.getElementById("save").disabled = true;
    } catch (e) {
      status.textContent = `save failed: ${e.message}`;
      status.className = "err";
    }
  };
}

async function load() {
  const dates = await getJSON(`/data/${TYPE}/dates.json`).catch(() => []);
  const picker = document.getElementById("date-picker");
  picker.replaceChildren(...dates.map(d => el("option", { value: d }, d)));
  const date = hashDate() || dates.at(-1);
  if (!date) {
    document.querySelector("main").replaceChildren(
      el("div", { class: "empty" },
         `no OA output for ${TYPE} yet — run \`onix oa <date> ${TYPE}\``));
    return;
  }
  picker.value = date;
  picker.onchange = () => { location.hash = `date=${picker.value}`; };
  const dir = `/data/${TYPE}/${dayDir(date)}`;
  const [rows, sum, graph, story, geo, ing] = await Promise.all([
    getJSON(`${dir}/suspicious.json`), getJSON(`${dir}/summary.json`),
    getJSON(`${dir}/graph.json`),
    getJSON(`${dir}/storyboard.json`).catch(() => ({ threats: [] })),
    getJSON(`${dir}/geo.json`).catch(() => ({ points: [], countries: [] })),
    getJSON(`${dir}/ingest.json`).catch(() => ({ available: false }))]);
  allRows = rows;
  currentDate = date;
  labels.clear();
  tableSort = null;
  tableFilter = "";
  const filt = document.getElementById("table-filter");
  filt.value = "";
  filt.oninput = () => { tableFilter = filt.value.trim(); renderMainTable(); };
  document.getElementById("save").disabled = true;
  document.getElementById("drill-panel").hidden = true;
  // Hosted notebooks for the current datatype (the reference hosts
  // investigation notebooks next to the dashboards): "notebook" opens
  // the server-rendered template, "run" executes it against this
  // day's data (POST /notebooks/run) and shows the live outputs, the
  // arrow downloads the .ipynb for a full Jupyter session.
  const nb = document.getElementById("notebook-link");
  nb.href = `/data/notebooks/${TYPE}_threat_investigation.ipynb`;
  nb.setAttribute("download", `${TYPE}_threat_investigation.ipynb`);
  document.getElementById("notebook-view").href = `/notebooks/${TYPE}.html`;
  // "edit" opens the in-dashboard editor: cells editable in place,
  // executed against a PERSISTENT kernel session (state carries
  // between runs), saved back to the hosted template.
  document.getElementById("notebook-edit").href =
    `/notebook.html?datatype=${TYPE}&date=${encodeURIComponent(date)}`;
  const nbRun = document.getElementById("notebook-run");
  let nbRunning = false;          // one kernel at a time per dashboard
  nbRun.onclick = async (ev) => {
    ev.preventDefault();
    if (nbRunning) return;
    nbRunning = true;
    nbRun.textContent = "⏳ running";
    // Open the tab NOW, inside the user activation — after a long
    // await, popup blockers would return null and discard the result.
    const w = window.open("", "_blank");
    if (w) w.document.write("<title>onix notebook</title>running…");
    try {
      const resp = await fetch("/notebooks/run", {
        method: "POST",
        headers: {"Content-Type": "application/json"},
        body: JSON.stringify({datatype: TYPE, date: currentDate}),
      });
      if (!resp.ok) throw new Error(`${resp.status} ${resp.statusText}`);
      const html = await resp.text();
      if (w) {
        w.document.open(); w.document.write(html); w.document.close();
      }
    } catch (e) {
      if (w) w.close();
      alert(`notebook run failed: ${e.message}`);
    } finally {
      nbRunning = false;
      nbRun.textContent = "▶ run";
    }
  };
  renderTiles(sum);
  renderBars("hist", sum.histogram.counts,
    (i, v) => `bin ${i}: ${v} events`);
  renderBars("timeline", sum.timeline_hourly,
    (i, v) => `${String(i).padStart(2, "0")}:00: ${v} events`);
  // Hour drill-down: a bar click opens that hour's suspicious rows.
  document.querySelectorAll("#timeline rect.bar").forEach((bar, hh) => {
    bar.classList.add("clickable");
    bar.addEventListener("click", () => {
      const rows = allRows.filter(r => Math.floor(hourFracOf(r) ?? -1) === hh);
      openDrill(`hour ${String(hh).padStart(2, "0")}:00`, rows);
    });
  });
  renderClients(sum);
  renderEventTimeline(rows);
  renderGraph(graph);
  renderStoryboard(story);
  renderGeo(geo);
  renderIngest(ing, sum);
  renderMainTable();
}

window.addEventListener("hashchange", load);
window.addEventListener("DOMContentLoaded", load);
